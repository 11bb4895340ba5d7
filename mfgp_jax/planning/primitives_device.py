"""Device-resident motion-primitive synthesis + rollout (jittable).

The host synthesis (planning/primitives.py, reference/GraceRIGV3.py:86-294)
grows a variable-length primitive list with end-of-sequence fixups; this
module re-expresses it with STATIC shapes so trajectory generation and
evaluation run on device, vmapped over whole candidate batches — the
enabler for the fully on-device RIG planner (planning/rig_device.py).

Layout: a trajectory is a fixed (MAX_LEGS, 4) array of rows
``(leg_type, p1, p2, p3)`` with ``leg_type == NOOP`` padding:

  SPIRAL   (dz, radius, speed)      GLIDE  (glide_path, dz, speed)
  SWIM     (dist, speed, 0)         FLATDIVE (dz, speed, 0)

``MAX_LEGS = 2 * num_legs + 1``: each drawn leg can emit up to two
primitives in the fixup cases (close-out + swim remainder) plus one final
surfacing leg — the exact worst case of the host algorithm.

Semantics match the host version case for case (same fixups, same
SwimEnergy argument-order quirk via primitives.swim_energy numerics, same
variance/underwater-time accrual with surface resets). The random draws
use a jax key instead of numpy's Generator, so individual trajectories
differ from host ones draw-for-draw; the INVARIANTS (end at surface,
cover the commanded distance, identical budget/time accounting for a
given primitive sequence) are what the tests pin.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.planning.primitives import AgentConfig, Leg

NOOP = -1
SPIRAL = int(Leg.SPIRAL)
GLIDE = int(Leg.GLIDE)
SWIM = int(Leg.SWIM)
FLATDIVE = int(Leg.FLATDIVE)


def _swim_energy(t, cfg: AgentConfig):
    """primitives.swim_energy, jittable (quirk preserved — see there)."""
    f, a = cfg.tail_amp, cfg.tail_freq
    wt = 4 * math.pi * f * t
    return 0.5 * math.pi * a**2 * f * (jnp.sin(wt) + wt)


def _leg_time_dist(leg, p1, p2, p3, cfg: AgentConfig):
    """(time, horizontal distance) of one primitive row (closed form)."""
    t = jnp.select(
        [leg == SPIRAL, leg == GLIDE, leg == SWIM, leg == FLATDIVE],
        [jnp.abs(p1 / p3), jnp.abs(p2 / p3), p1 / p2, jnp.abs(p1 / p2)],
        0.0)
    d = jnp.select(
        [leg == GLIDE, leg == SWIM],
        [p2 / jnp.tan(p1), p1],
        0.0)
    return t, d


def _leg_budget(leg, p1, p2, p3, cfg: AgentConfig):
    t, _ = _leg_time_dist(leg, p1, p2, p3, cfg)
    return jnp.select(
        [leg == SPIRAL, leg == GLIDE, leg == SWIM, leg == FLATDIVE],
        [cfg.glide_energy, cfg.glide_energy,
         _swim_energy(t, cfg) * cfg.tail_energy_scale, cfg.flat_dive_energy],
        0.0)


def evaluate_trajectory_device(prims, cfg: AgentConfig):
    """Jittable rollout of a padded (MAX_LEGS, 4) primitive array.

    Returns (time, dist, max_underwater_time, waypoints (MAX_LEGS+1, 4),
    budget) — the device counterpart of primitives.evaluate_trajectory,
    identical accounting (waypoint rows: dist, depth, time, variance;
    variance resets at the surface; per-submersion max underwater time).
    Padding rows produce zero-duration waypoints that repeat the state.
    """
    def step(carry, prim):
        t, dist, depth, var, uw, tuw_cur, tuw_max, budget = carry
        leg = prim[0].astype(jnp.int32)
        p1, p2, p3 = prim[1], prim[2], prim[3]
        leg_t, leg_d = _leg_time_dist(leg, p1, p2, p3, cfg)
        leg_t = jnp.where(leg == NOOP, 0.0, leg_t)
        leg_d = jnp.where(leg == NOOP, 0.0, leg_d)
        dz = jnp.select([leg == SPIRAL, leg == GLIDE, leg == FLATDIVE],
                        [p1, p2, p1], 0.0)
        # swims accrue underwater time/variance only while submerged
        accrue = jnp.where(leg == SWIM, uw.astype(p1.dtype), 1.0)
        accrue = jnp.where(leg == NOOP, 0.0, accrue)
        t = t + leg_t
        tuw_cur = tuw_cur + accrue * leg_t
        var = var + cfg.variance_rate * accrue * leg_t
        dist = dist + leg_d
        depth = depth + dz
        budget = budget + jnp.where(leg == NOOP, 0.0,
                                    _leg_budget(leg, p1, p2, p3, cfg))
        submerged = depth > 0.0
        resurfaced = (~submerged) & (depth <= 0.1) & uw
        tuw_max = jnp.maximum(tuw_max, tuw_cur)
        tuw_cur = jnp.where(resurfaced, 0.0, tuw_cur)
        uw = jnp.where(submerged, True, jnp.where(resurfaced, False, uw))
        var = jnp.where(depth <= 0.0, 0.0, var)
        carry = (t, dist, depth, var, uw, tuw_cur, tuw_max, budget)
        return carry, jnp.stack([dist, depth, t, var])

    z = jnp.zeros((), prims.dtype)
    init = (z, z, z, z, jnp.zeros((), bool), z, z, z)
    (t, dist, depth, var, uw, tuw_cur, tuw_max, budget), pts = \
        jax.lax.scan(step, init, prims)
    tuw_max = jnp.maximum(tuw_max, tuw_cur)
    pts = jnp.concatenate([jnp.zeros((1, 4), prims.dtype), pts], axis=0)
    budget = budget + cfg.time_energy * t
    return t, dist, tuw_max, pts, budget


def _mk(leg: int, p1, p2, p3):
    dt = jnp.asarray(p1).dtype
    return jnp.stack([jnp.full((), float(leg), dt),
                      jnp.asarray(p1, dt), jnp.asarray(p2, dt),
                      jnp.asarray(p3, dt)])


def generate_trajectory_device(key, choices, distance, cfg: AgentConfig,
                               num_legs: int = 3):
    """Jittable counterpart of primitives.generate_trajectory.

    choices: (num_legs,) int leg types; distance: scalar. Returns a
    (2*num_legs+1, 4) padded primitive array satisfying the host
    invariants (surface finish, exact distance coverage). vmap over
    (key, choices, distance) for whole candidate batches; jit with ``cfg``
    closed over (AgentConfig is not hashable, so it cannot be a static
    jit argument).
    """
    max_legs = 2 * num_legs + 1
    dtype = jnp.result_type(distance, jnp.float32)
    distance = jnp.asarray(distance, dtype)
    prims = jnp.full((max_legs, 4), float(NOOP), dtype)
    prims = prims.at[:, 1].set(1.0)  # benign params on padding rows
    prims = prims.at[:, 2].set(1.0)
    prims = prims.at[:, 3].set(1.0)

    def surface_prim(depth, key, sign):
        if cfg.surface_by_spiral:
            r = cfg.min_radius + jax.random.uniform(key, dtype=dtype) * (
                cfg.max_radius - cfg.min_radius)
            return _mk(SPIRAL, -depth, r, jnp.full((), sign
                                                   * cfg.spiral_speed,
                                                   dtype))
        return _mk(FLATDIVE, -depth,
                   jnp.full((), sign * cfg.flat_dive_speed, dtype),
                   jnp.ones((), dtype))

    dist = jnp.zeros((), dtype)
    depth = jnp.zeros((), dtype)
    done = jnp.zeros((), bool)
    slot = 0
    keys = jax.random.split(key, num_legs + 1)
    noop = jnp.asarray([float(NOOP), 1.0, 1.0, 1.0], dtype)

    for cnt in range(num_legs):  # static loop: slots are compile-time
        c = choices[cnt]
        k1, k2, k3 = jax.random.split(keys[cnt], 3)
        u_d = jax.random.uniform(k1, dtype=dtype)
        u_r = jax.random.uniform(k2, dtype=dtype)
        u_g = jax.random.uniform(k3, dtype=dtype)
        final = cnt == num_legs - 1

        d_depth = u_d * cfg.max_depth  # target absolute depth draw
        dz = d_depth - depth
        r = cfg.min_radius + u_r * (cfg.max_radius - cfg.min_radius)
        gp_draw = cfg.min_glide_path + u_g * (cfg.max_glide_path
                                              - cfg.min_glide_path)
        d_swim = u_d * (distance - dist)

        # drawn primitive per leg type
        prim = jnp.select(
            [c == SPIRAL, c == GLIDE, c == SWIM, c == FLATDIVE],
            [_mk(SPIRAL, dz, r, jnp.sign(dz) * cfg.spiral_speed),
             _mk(GLIDE, gp_draw * jnp.sign(dz), dz,
                 jnp.sign(dz) * cfg.vert_glide_speed),
             _mk(SWIM, d_swim, jnp.full((), cfg.swim_speed, dtype),
                 jnp.ones((), dtype)),
             _mk(FLATDIVE, dz, jnp.sign(dz) * cfg.flat_dive_speed,
                 jnp.ones((), dtype))],
            noop)
        leg = prim[0].astype(jnp.int32)
        tt, dt = _leg_time_dist(leg, prim[1], prim[2], prim[3], cfg)
        overshoot = dist + dt >= distance

        # ---- close-out variants (final leg or overshoot) ----
        rem = distance - dist
        # glide close-out: descend/ascend -depth at >= min glide angle,
        # then swim any remainder
        gp_close = jnp.sign(jnp.where(depth > 0, -1.0, 1.0)) * jnp.maximum(
            jnp.abs(jnp.arctan2(depth, rem)), cfg.min_glide_path)
        glide_a = _mk(GLIDE, gp_close, -depth,
                      jnp.full((), -cfg.vert_glide_speed, dtype))
        _, glide_d = _leg_time_dist(jnp.full((), GLIDE, jnp.int32),
                                    glide_a[1], glide_a[2], glide_a[3], cfg)
        glide_b = _mk(SWIM, jnp.maximum(rem - glide_d, 0.0),
                      jnp.full((), cfg.swim_speed, dtype),
                      jnp.ones((), dtype))
        glide_use_b = rem - glide_d > 0.0

        swim_a = _mk(SWIM, rem, jnp.full((), cfg.swim_speed, dtype),
                     jnp.ones((), dtype))

        # spiral/flatdive final: surface first, then swim the remainder
        vert_first = jnp.where(c == SPIRAL,
                               _mk(SPIRAL, -depth, r,
                                   jnp.full((), -cfg.spiral_speed, dtype)),
                               _mk(FLATDIVE, -depth,
                                   jnp.full((), -cfg.flat_dive_speed,
                                            dtype), jnp.ones((), dtype)))

        is_vert = (c == SPIRAL) | (c == FLATDIVE)
        closing = final | overshoot
        # overshoot + non-final only closes for GLIDE/SWIM (host `break`);
        # vertical legs never overshoot (dt == 0), so closing == final there
        emit_a = jnp.where(
            closing,
            jnp.where(is_vert, vert_first,
                      jnp.where(c == GLIDE, glide_a, swim_a)),
            prim)
        emit_b = jnp.where(
            closing,
            jnp.where(is_vert,
                      _mk(SWIM, rem, jnp.full((), cfg.swim_speed, dtype),
                          jnp.ones((), dtype)),
                      jnp.where((c == GLIDE) & glide_use_b, glide_b, noop)),
            noop)
        # host SWIM-final surfaces after the swim when submerged
        swim_final_surface = closing & (c == SWIM) & (depth > 0)
        emit_b = jnp.where(swim_final_surface,
                           surface_prim(depth, keys[-1], -1.0), emit_b)

        emit_a = jnp.where(done, noop, emit_a)
        emit_b = jnp.where(done, noop, emit_b)
        prims = prims.at[slot].set(emit_a)
        prims = prims.at[slot + 1].set(emit_b)
        slot += 2

        la = emit_a[0].astype(jnp.int32)
        lb = emit_b[0].astype(jnp.int32)
        _, da = _leg_time_dist(la, emit_a[1], emit_a[2], emit_a[3], cfg)
        _, db = _leg_time_dist(lb, emit_b[1], emit_b[2], emit_b[3], cfg)
        da = jnp.where(la == NOOP, 0.0, da)
        db = jnp.where(lb == NOOP, 0.0, db)
        dza = jnp.select([la == SPIRAL, la == GLIDE, la == FLATDIVE],
                         [emit_a[1], emit_a[2], emit_a[1]], 0.0)
        dzb = jnp.select([lb == SPIRAL, lb == GLIDE, lb == FLATDIVE],
                         [emit_b[1], emit_b[2], emit_b[1]], 0.0)
        dist = dist + da + db
        depth = depth + dza + dzb
        done = done | closing

    # final surfacing when still submerged (host :          depth > 0)
    prims = prims.at[slot].set(
        jnp.where(depth > 0.01, surface_prim(depth, keys[-1], +1.0), noop))
    return prims


def generate_trajectories_batch(key, choices, distances, cfg: AgentConfig):
    """vmapped synthesis: choices (B, n) int, distances (B,) -> (B, 2n+1, 4)."""
    B, n = choices.shape
    keys = jax.random.split(key, B)
    fn = partial(generate_trajectory_device, cfg=cfg, num_legs=n)
    return jax.vmap(lambda k, c, d: fn(k, c, d))(keys, choices, distances)


def padded_to_prims(padded) -> list:
    """Padded (L, 4) device rows -> host primitive tuples (NOOPs dropped).

    The inverse mapping used when a device-planned path is handed to host
    consumers (runtime flight plans, evaluate_trajectory)."""
    out = []
    for row in np.asarray(padded):
        leg = int(row[0])
        if leg == NOOP:
            continue
        if leg in (SPIRAL, GLIDE):
            out.append((Leg(leg), float(row[1]), float(row[2]),
                        float(row[3])))
        else:  # SWIM / FLATDIVE
            out.append((Leg(leg), float(row[1]), float(row[2])))
    return out
