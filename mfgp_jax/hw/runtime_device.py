"""Device robot runtime: the whole sense->estimate->control loop as ONE
``lax.scan``.

``hw.runtime.RobotRuntime`` mirrors the reference's per-tick host loop
(reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
761-1033) in numpy — the right call for soft-real-time robot hardware.
This module is the same loop as a pure JAX program, so a flown plan
becomes one compiled scan over ticks:

* the :class:`~mfgp_jax.hw.plant.GliderPlant` dynamics (actuator slew,
  first-order pitch, buoyancy vertical speed, tail-wave propulsion +
  glide polar) re-expressed branch-free;
* sensing with per-tick noise draws (`jax.random`, counter-derived keys);
* the tail first-order input estimator, input-rate KF and energy-budget
  integration (reference :795-806), pitch KF, fidelity-binned field
  sampling by ``tr(Pxhat[0:2,0:2])`` (:809-819), the gated position fix,
  the body-velocity observer with its divergence reset (:845-861), the
  surface-gated 6-state position KF (:862-872) and depth-error KF (:874);
* the four per-primitive control laws — FlatDive (:884-900), Swim
  (:902-934), Spiral (:937-955), Glide (:958-981) — and the end-of-path
  surfacing trim (:983-988), selected by a one-hot over the leg code with
  the host loop's shared rate-gate latches.

Why: the host loop steps 20 Hz python; here an entire flight is one XLA
launch, ``vmap``s over plans (flight ensembles, Monte-Carlo tracking
studies), and — the real target — inlines into the single-launch mission
program (``sim.mission_device`` ``flight="dynamic"``), making the WHOLE
closed-loop experiment, vehicle dynamics included, one device program.

Semantics notes (deliberate, mirrored from the host runtime):

* Tick order, gate conditions, and actuator saturations follow
  ``RobotRuntime.fly`` exactly; with all noise scales zero the two
  runtimes integrate the same trajectory to float tolerance
  (tests/test_runtime_device.py).
* Noise parity is statistical, not samplewise: the host draws numpy
  normals in loop order, this draws ``jax.random`` normals from
  per-tick counters.
* The scan runs to a STATIC tick capacity; ticks beyond the plan's
  ``ceil(t_end/dt)+1`` (the host loop length) freeze the carry, so
  results are independent of the padding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.estimation.observers import (GliderParams,
                                           body_velocity_observer,
                                           euler_to_rotm)
from mfgp_jax.hw.plant import PlantParams
from mfgp_jax.hw.runtime import RuntimeConfig, derived_tail_weight
from mfgp_jax.planning.primitives import AgentConfig, Leg


def _sat(x, lo, hi):
    return jnp.clip(x, lo, hi)


def _angle_wrap(a, wrap_val):
    return (a + wrap_val) % (2.0 * wrap_val) - wrap_val


def _yaw_correction(yaw, yaw_d, wrap_val=jnp.pi):
    """hw.controllers.yaw_correction at the runtime's radian call site
    (the +/-70 clamp never binds in radians)."""
    return _sat(_angle_wrap(yaw - yaw_d, wrap_val), -70.0, 70.0)


def _pump_spd_control2(depth, e_state, gains, k_max_depth, max_depth):
    u1 = jnp.dot(gains, e_state.reshape(-1))
    u1 = u1 + k_max_depth * (depth - max_depth) * ((depth + 0.001)
                                                   > max_depth)
    return _sat(u1, -100.0, 100.0)


def _mass_spd_control(pitch, theta_d, pitch_vel, gains):
    pkp, pkd = gains
    return _sat(_sat(pkd * (-pitch_vel), -100.0, 100.0)
                + _sat(pkp * (theta_d - pitch), -100.0, 100.0),
                -100.0, 100.0)


def _tail_angle(t, bias, amp, freq):
    """hw.plant.TailWave.angle (square gait) branch-free; amp == 0
    degenerates to the bias exactly like the host early-return."""
    phase = jnp.floor(2.0 * jnp.maximum(freq, 0.05) * t) % 2
    return bias + jnp.where(phase < 1, amp, -amp)


def _kf(x, P, A, Q, z, H, R):
    """One predict+update, hw.runtime.RobotRuntime._kf verbatim."""
    x = A @ x
    P = A @ P @ A.T + Q
    PHT = P @ H.T
    S = H @ PHT + R
    K = jnp.linalg.solve(S.T, PHT.T).T
    x = x + K @ (z - H @ x)
    P = (jnp.eye(P.shape[0], dtype=P.dtype) - K @ H) @ P
    return x, P


class DevicePlan(NamedTuple):
    """A padded flight plan: fixed-capacity (waypoints, legs) arrays.

    ``wp``: (Wcap, 4) rows (x, y, z, t) — valid rows first, padding
    repeats the last valid row with strictly increasing times so
    ``jnp.interp`` clamps; ``legs``: (Lcap, 4) rows
    (code, a, b, c) in the host runtime's unpacking order — FLATDIVE
    (dz, zdot_d, -), SWIM (d, speed, -), SPIRAL (dz, delta_d, zdot_d),
    GLIDE (theta_gd, dz, zdot_d)."""

    wp: jax.Array
    n_wp: jax.Array
    legs: jax.Array
    n_legs: jax.Array
    t_end: jax.Array


class DeviceRuntime:
    """The RobotRuntime loop as a jitted scan. One instance per
    (agent, runtime-config, capacities); `fly` compiles once per tick
    capacity and is vmappable over (plan, carry, key)."""

    def __init__(self, agent_cfg: AgentConfig,
                 cfg: RuntimeConfig | None = None,
                 plant_params: PlantParams | None = None,
                 field=None, max_depth: Optional[float] = None,
                 dtype=jnp.float64, w_cap: int = 64, l_cap: int = 48,
                 glide_stride: int = 1):
        self.agent = agent_cfg
        self.cfg = cfg or RuntimeConfig()
        self.plant = plant_params or PlantParams.from_agent(agent_cfg)
        self.field = field  # fn (x, y, depth) -> value, traceable
        self.max_depth = (max_depth if max_depth is not None
                          else agent_cfg.max_depth)
        self.dtype = dtype
        self.w_cap, self.l_cap = int(w_cap), int(l_cap)
        self.glide_stride = int(glide_stride)
        if self.glide_stride < 1:
            raise ValueError("glide_stride must be >= 1")
        c = self.cfg
        if c.udot_weights is None:
            self.w_udot = np.array(
                [1.0, 1.0, derived_tail_weight(agent_cfg, c.dt, c.k_delta),
                 1.0])
        else:
            self.w_udot = np.asarray(c.udot_weights, float)
        self.time_energy = (c.time_energy if c.time_energy is not None
                            else agent_cfg.time_energy)
        # observer constants: the same ballast calibration as
        # RobotRuntime.__init__ (terminal-sink match to the plant)
        p = GliderParams()
        v_term = self.plant.buoy_per_pct * 55.0
        lp = (0.5 * p.rho * p.S * p.CD0 * v_term**2) / (0.45 * p.g)
        self.glider_params = p._replace(lp=max(lp, 1e-6), bc=0.55)
        self._fly_jit = jax.jit(self._fly_impl,
                                static_argnames=("t_cap",))

    # -- state ----------------------------------------------------------------
    def init_carry(self, x0: float = 0.0, y0: float = 0.0) -> dict:
        """Fresh persistent state (plant + estimators + latches), the
        device image of RobotRuntime.__init__'s estimator block."""
        dt = self.dtype
        z3 = jnp.zeros((3,), dt)
        pp = self.plant
        return dict(
            # plant
            px=jnp.asarray(x0, dt), py=jnp.asarray(y0, dt),
            pz=jnp.asarray(0.0, dt), pitch=jnp.asarray(0.0, dt),
            yaw=jnp.asarray(0.0, dt), roll=jnp.asarray(0.0, dt),
            mass_pos=jnp.asarray(pp.mass_neutral, dt),
            pump_pos=jnp.asarray(pp.pump_neutral, dt),
            mass_cmd=jnp.asarray(pp.mass_neutral, dt),
            pump_cmd=jnp.asarray(pp.pump_neutral, dt),
            tail_bias=jnp.asarray(0.0, dt), tail_amp=jnp.asarray(0.0, dt),
            tail_freq=jnp.asarray(1.0, dt),
            pitch_rate=jnp.asarray(0.0, dt),
            yaw_rate=jnp.asarray(0.0, dt),
            vx=jnp.asarray(0.0, dt), vy=jnp.asarray(0.0, dt),
            vz=jnp.asarray(0.0, dt),
            # estimators
            delta_hat=jnp.asarray(0.0, dt),
            u2_prev=jnp.asarray(0.0, dt),
            inp_x=jnp.zeros((4,), dt), inp_P=0.1 * jnp.eye(4, dtype=dt),
            pitch_x=jnp.zeros((2,), dt),
            pitch_P=0.1 * jnp.eye(2, dtype=dt),
            xhat=jnp.asarray([x0, y0, 0, 0, 0, 0], dt),
            xhat_P=1.0 * jnp.eye(6, dtype=dt),
            zerr_x=jnp.zeros((4,), dt), zerr_P=0.1 * jnp.eye(4, dtype=dt),
            vb=jnp.asarray([1e-4, 0.0, 1e-4], dt),
            Phat=jnp.asarray([x0, y0, 0.0], dt),
            # latches
            last_fix=z3, last_fix_vel=z3,
            last_fix_t=jnp.asarray(-1e9, dt),
            last_sample_t=jnp.asarray(-1e9, dt),
            max_blue=jnp.asarray(1e-12, dt),
            tlast_ctrl=jnp.asarray(-1e9, dt),
            tlast_p_ctrl=jnp.asarray(-1e9, dt),
            # lifetime clocks
            t=jnp.asarray(0.0, dt), budget=jnp.asarray(0.0, dt),
        )

    def pack_plan(self, waypoints, legs) -> DevicePlan:
        """Host helper: pad (waypoints, legs) from
        hw.runtime.chain_to_flight_plan into a DevicePlan."""
        dt = self.dtype
        wp = np.asarray(waypoints, float)
        n_wp = wp.shape[0]
        if n_wp > self.w_cap or len(legs) > self.l_cap:
            raise ValueError(f"plan exceeds capacity ({n_wp}/{self.w_cap} "
                             f"waypoints, {len(legs)}/{self.l_cap} legs)")
        pad = np.repeat(wp[-1:], self.w_cap - n_wp, axis=0)
        pad[:, 3] = wp[-1, 3] + 1.0 + np.arange(pad.shape[0])
        wp_p = np.concatenate([wp, pad], axis=0)
        lrows = np.zeros((self.l_cap, 4))
        for i, prim in enumerate(legs):
            lrows[i, 0] = float(prim[0])
            for j, v in enumerate(prim[1:][:3]):
                lrows[i, 1 + j] = float(v)
        return DevicePlan(
            wp=jnp.asarray(wp_p, dt), n_wp=jnp.asarray(n_wp, jnp.int32),
            legs=jnp.asarray(lrows, dt),
            n_legs=jnp.asarray(len(legs), jnp.int32),
            t_end=jnp.asarray(wp[-1, 3], dt))

    # -- one tick -------------------------------------------------------------
    def _tick(self, st, plan: DevicePlan, t0, key, i, n_sub: int = 1):
        """One runtime tick of ``n_sub * cfg.dt`` seconds. ``n_sub`` is
        STATIC: 1 is the host loop's fine tick; >1 is a coarse
        multi-rate tick (same physics and estimator discretizations, a
        longer step) used by the glide-stride scan."""
        c, a, pp = self.cfg, self.agent, self.plant
        dtype = self.dtype
        dt_f = c.dt * n_sub
        dt = jnp.asarray(dt_f, dtype)
        nk = jax.random.fold_in(key, i)
        noise = jax.random.normal(nk, (13,), dtype)

        # --- plant step (hw.plant.GliderPlant.step) -----------------------
        st = dict(st)
        mass_prev, pump_prev = st["mass_pos"], st["pump_pos"]
        st["mass_pos"] += _sat(st["mass_cmd"] - st["mass_pos"],
                               -pp.mass_rate * dt, pp.mass_rate * dt)
        st["pump_pos"] += _sat(st["pump_cmd"] - st["pump_pos"],
                               -pp.pump_rate * dt, pp.pump_rate * dt)
        pitch_ss = pp.pitch_per_pct * (st["mass_pos"] - pp.mass_neutral)
        dpitch = pp.pitch_response * (pitch_ss - st["pitch"])
        st["pitch_rate"] = dpitch
        st["pitch"] += dpitch * dt
        w = pp.buoy_per_pct * (pp.pump_neutral - st["pump_pos"])
        dyaw = -pp.yaw_per_bias * jnp.deg2rad(st["tail_bias"])
        st["yaw_rate"] = dyaw
        st["yaw"] += dyaw * dt
        v_swim = jnp.where(
            st["tail_amp"] != 0.0,
            (pp.swim_speed * (jnp.abs(st["tail_amp"]) / pp.ref_amp_deg)
             * (st["tail_freq"] / pp.ref_freq)), 0.0)
        glide_ok = ((jnp.abs(st["pitch"]) > pp.min_glide_pitch)
                    & (jnp.abs(w) > 1e-9))
        ratio = jnp.minimum(
            1.0 / jnp.tan(jnp.maximum(jnp.abs(st["pitch"]), 1e-6)),
            pp.max_glide_ratio)
        v_h = v_swim + jnp.where(glide_ok, jnp.abs(w) * ratio, 0.0)
        st["vx"] = v_h * jnp.cos(st["yaw"])
        st["vy"] = v_h * jnp.sin(st["yaw"])
        st["vz"] = jnp.where((st["pz"] > 0.0) | (w > 0.0), w, 0.0)
        st["px"] += st["vx"] * dt
        st["py"] += st["vy"] * dt
        st["pz"] = jnp.maximum(0.0, st["pz"] + w * dt)
        st["t"] += dt
        t_abs = st["t"]
        t = t_abs - t0  # plan-relative

        # --- primitive lookup (reference :763-774) ------------------------
        valid_wp = jnp.arange(self.w_cap) < plan.n_wp
        cnt = jnp.sum((t > plan.wp[:, 3]) & valid_wp)
        p_cnt = jnp.clip(cnt - 1, 0, jnp.maximum(plan.n_legs - 1, 0))
        in_plan = (t <= plan.t_end) & (plan.n_legs > 0)
        leg = plan.legs[p_cnt]
        code = jnp.where(in_plan, leg[0], -1.0)
        is_fd = code == float(Leg.FLATDIVE)
        is_sw = code == float(Leg.SWIM)
        is_sp = code == float(Leg.SPIRAL)
        is_gl = code == float(Leg.GLIDE)
        is_none = code < 0
        wypnt = jnp.where(
            in_plan,
            plan.wp[jnp.minimum(p_cnt + 1, plan.n_wp - 1), :3],
            plan.wp[plan.n_wp - 1, :3])
        tar = jnp.array([jnp.interp(t, plan.wp[:, 3], plan.wp[:, 0]),
                         jnp.interp(t, plan.wp[:, 3], plan.wp[:, 1]),
                         jnp.interp(t, plan.wp[:, 3], plan.wp[:, 2])])

        # --- sensors (reference :780-792) ---------------------------------
        roll = st["roll"] + c.euler_noise * noise[0]
        pitch_m = st["pitch"] + c.euler_noise * noise[1]
        yaw_m = st["yaw"] + c.euler_noise * noise[2]
        gx = 0.0 + c.gyro_noise * noise[3]
        gy = st["pitch_rate"] + c.gyro_noise * noise[4]
        gz = st["yaw_rate"] + c.gyro_noise * noise[5]
        depth = st["pz"] + c.depth_noise * noise[6]
        tail_deg = _tail_angle(t_abs, st["tail_bias"], st["tail_amp"],
                               st["tail_freq"])
        u0 = st["mass_pos"] / 100.0
        u1_in = st["pump_pos"] / 100.0
        u2_in = jnp.deg2rad(tail_deg)
        blue = (jnp.asarray(self.field(st["px"], st["py"], st["pz"]),
                            dtype)
                if self.field is not None else jnp.asarray(0.0, dtype))

        # --- tail input estimator + input KF + budget (:795-806) ----------
        H_inp = jnp.asarray(
            [[1.0, 0, 0, 0], [0, 1.0, 0, 0]], dtype)
        if n_sub == 1:
            A_inp = jnp.eye(4, dtype=dtype) + jnp.diag(
                jnp.array([dt, dt], dtype), 2)
            ix, iP = _kf(st["inp_x"][:, None], st["inp_P"], A_inp,
                         jnp.diag(jnp.asarray(c.q_inp, dtype)) * dt,
                         jnp.array([[u0], [u1_in]]), H_inp,
                         jnp.diag(jnp.asarray(c.r_inp, dtype)))
            st["inp_x"], st["inp_P"] = ix[:, 0], iP
            dmass, dpump = ix[2, 0], ix[3, 0]
            ddelta = c.k_delta * _sat(u2_in - st["delta_hat"], -jnp.pi,
                                      jnp.pi)
            st["delta_hat"] = _sat(
                st["delta_hat"] + ddelta * dt - 0.5 * c.k_delta * ddelta
                * dt**2, -math.radians(110), math.radians(110))
            udot = jnp.array([dmass**2, dpump**2, ddelta**2,
                              self.time_energy])
            st["budget"] += jnp.dot(
                udot, jnp.asarray(self.w_udot, dtype)) * dt
            st["u2_prev"] = u2_in
        else:
            # coarse tick: the input-rate estimators feed the ENERGY
            # integral with rate-SQUARED terms, so they must see the
            # fine actuator ramp, not one coarse jump (the tail
            # first-order estimator is not even stable past
            # k_delta * dt = 2). Sub-step the actuator slew + 4-state
            # input KF + tail recurrence at the FINE dt — cheap scalar /
            # 4x4 work; the expensive blocks (6-state KF with its 9-row
            # gated H, observer, control laws) stay on the coarse step.
            # The sub-stepped slew reproduces the coarse plant endpoint
            # exactly (saturated approach to a fixed command).
            dtf = jnp.asarray(c.dt, dtype)
            A_f = jnp.eye(4, dtype=dtype) + jnp.diag(
                jnp.array([dtf, dtf], dtype), 2)
            Q_f = jnp.diag(jnp.asarray(c.q_inp, dtype)) * dtf
            R_f = jnp.diag(jnp.asarray(c.r_inp, dtype))
            w = jnp.asarray(self.w_udot, dtype)
            mp, pq = mass_prev, pump_prev
            ix, iP = st["inp_x"][:, None], st["inp_P"]
            rate2 = jnp.asarray(0.0, dtype)
            dd2 = jnp.asarray(0.0, dtype)
            ddelta = jnp.asarray(0.0, dtype)
            u2p = st["u2_prev"]
            for j in range(n_sub):
                mp += _sat(st["mass_cmd"] - mp,
                           -pp.mass_rate * dtf, pp.mass_rate * dtf)
                pq += _sat(st["pump_cmd"] - pq,
                           -pp.pump_rate * dtf, pp.pump_rate * dtf)
                ix, iP = _kf(ix, iP, A_f, Q_f,
                             jnp.array([[mp / 100.0], [pq / 100.0]]),
                             H_inp, R_f)
                rate2 += ix[2, 0]**2 * w[0] + ix[3, 0]**2 * w[1]
                # the tail estimator tracks the commanded angle, which
                # on the host ramps per fine tick; feed the sub-steps
                # the ramp, not one coarse jump (rate^2 energy scales
                # with jump size)
                u2_j = u2p + (j + 1) / n_sub * (u2_in - u2p)
                ddelta = c.k_delta * _sat(u2_j - st["delta_hat"],
                                          -jnp.pi, jnp.pi)
                st["delta_hat"] = _sat(
                    st["delta_hat"] + ddelta * dtf
                    - 0.5 * c.k_delta * ddelta * dtf**2,
                    -math.radians(110), math.radians(110))
                dd2 += ddelta**2
            st["inp_x"], st["inp_P"] = ix[:, 0], iP
            dmass, dpump = ix[2, 0], ix[3, 0]
            st["budget"] += ((rate2 + w[2] * dd2) * dtf
                             + self.time_energy * w[3] * dt)
            st["u2_prev"] = u2_in
        A_pitch = jnp.asarray([[1.0, dt_f], [0.0, 1.0]], dtype)
        px_, pP_ = _kf(st["pitch_x"][:, None], st["pitch_P"], A_pitch,
                       0.0175 * jnp.diag(jnp.asarray([2.0, 3.0], dtype))
                       * dt,
                       jnp.array([[pitch_m], [gy]]),
                       jnp.diag(jnp.asarray([1.0, 0.0], dtype)),
                       0.0175 * jnp.diag(jnp.asarray([1.0, 10.0], dtype)))
        st["pitch_x"], st["pitch_P"] = px_[:, 0], pP_

        # --- fidelity-binned field sampling (:809-819) --------------------
        burst = ((blue > c.blue_thresh * st["max_blue"])
                 & (t_abs - st["last_sample_t"] > 0.25 / a.meas_rate))
        sample = (t_abs - st["last_sample_t"] > 1.0 / a.meas_rate) | burst
        st["max_blue"] = jnp.where(sample,
                                   jnp.maximum(st["max_blue"], blue),
                                   st["max_blue"])
        st["last_sample_t"] = jnp.where(sample, t_abs,
                                        st["last_sample_t"])
        cov_comp = st["xhat_P"][0, 0] + st["xhat_P"][1, 1]
        levs = jnp.asarray(list(a.fid_levels) or [0.25, 2.25, 6.25],
                           dtype)
        fid = jnp.where(cov_comp < levs[0], 1,
                        jnp.where(cov_comp < levs[1], 2, 3))
        # the host records the GPData row's position estimate HERE — with
        # this tick's position-KF update still pending (:816-819)
        sample_xh = st["xhat"][:3]

        # --- position fix (:821-842) --------------------------------------
        fix = t_abs - st["last_fix_t"] >= 1.0 / c.fix_rate
        truth = jnp.array([st["px"], st["py"], st["pz"]])
        vel = jnp.array([st["vx"], st["vy"], st["vz"]])
        st["last_fix"] = jnp.where(fix, truth + c.fix_noise * noise[7:10],
                                   st["last_fix"])
        st["last_fix_vel"] = jnp.where(
            fix, vel + c.fix_vel_noise * noise[10:13],
            st["last_fix_vel"])
        st["last_fix_t"] = jnp.where(fix, t_abs, st["last_fix_t"])
        tuav = (t_abs - st["last_fix_t"]) < 1.0
        use_gps = depth < c.at_surface

        # --- body-velocity observer (:845-861) ----------------------------
        if c.use_velocity_observer:
            R = euler_to_rotm(roll, pitch_m, yaw_m)
            dP, dvb = body_velocity_observer(
                R, jnp.array([gx, gy, gz]), st["vb"], depth,
                st["Phat"][2], u1_in, u2_in, self.glider_params)
            # the observer's strongly-typed f64 constants promote under
            # x64; its states live in the runtime dtype
            dP, dvb = dP.astype(dtype), dvb.astype(dtype)
            Phat = st["Phat"] + dP * dt
            vb = st["vb"] + dvb * dt * (c.dt < 0.5)
            diverged = (jnp.any(jnp.isnan(vb))
                        | (jnp.linalg.norm(vb) > c.vb_cap))
            st["Phat"] = jnp.where(
                diverged,
                jnp.array([st["last_fix"][0], st["last_fix"][1], depth]),
                Phat)
            st["vb"] = jnp.where(diverged,
                                 jnp.asarray([1e-4, 0.0, 1e-4], dtype), vb)
            vel_obs = (R @ st["vb"]).astype(dtype)
            use_vel = (~jnp.any(jnp.isnan(st["vb"]))
                       & (jnp.abs(ddelta) < math.radians(45)) & ~is_sw)
        else:
            vel_obs = jnp.zeros((3,), dtype)
            use_vel = jnp.asarray(False)

        # --- 6-state position KF with gated H (:862-872) ------------------
        g = (use_gps & tuav).astype(dtype)
        tv = tuav.astype(dtype)
        vo = use_vel.astype(dtype)
        H = jnp.concatenate([
            jnp.diag(jnp.array([g, g, 1.0, tv, tv, tv])),
            jnp.concatenate([jnp.zeros((3, 3), dtype),
                             vo * jnp.eye(3, dtype=dtype)], axis=1)],
            axis=0)
        dmp = c.damping
        A_x = (jnp.eye(6, dtype=dtype)
               + jnp.diag(jnp.asarray([dt_f] * 3, dtype), 3)
               + jnp.diag(jnp.asarray(
                   [0, 0, 0, dmp * dt_f, dmp * dt_f, dmp * dt_f], dtype)))
        z = jnp.concatenate([
            jnp.array([st["last_fix"][0], st["last_fix"][1], depth]),
            st["last_fix_vel"], vel_obs])[:, None]
        xh, xP = _kf(st["xhat"][:, None], st["xhat_P"], A_x,
                     jnp.diag(jnp.asarray(c.q_xhat, dtype)) * dt, z, H,
                     jnp.diag(jnp.asarray(c.r_xhat, dtype)))
        st["xhat"], st["xhat_P"] = xh[:, 0], xP

        # --- depth-error KF (:874-875) ------------------------------------
        A_z = (jnp.eye(4, dtype=dtype) + jnp.eye(4, k=1, dtype=dtype) * dt
               + jnp.eye(4, k=2, dtype=dtype) / 2 * dt**2
               + jnp.eye(4, k=3, dtype=dtype) / 6 * dt**3)
        zx, zP = _kf(st["zerr_x"][:, None], st["zerr_P"], A_z,
                     jnp.diag(jnp.asarray(c.q_depth_err, dtype)) * dt,
                     jnp.array([[depth - tar[2]]]),
                     jnp.asarray([[1.0, 0, 0, 0]], dtype),
                     jnp.asarray([[c.r_depth_err]], dtype))
        st["zerr_x"], st["zerr_P"] = zx[:, 0], zP

        # --- per-primitive control (:884-988) -----------------------------
        gains_d = jnp.asarray(c.linear_depth_gains, dtype)
        gains_p = c.linear_pitch_gains
        p_gate = t_abs - st["tlast_p_ctrl"] > 1.0 / c.pitch_control_rate
        c_gate = t_abs - st["tlast_ctrl"] > 1.0 / c.control_rate
        u1c = _pump_spd_control2(depth, st["zerr_x"], gains_d,
                                 c.k_max_depth, self.max_depth)
        # coarse multi-rate ticks fire each gate once per window; the
        # increment laws are normalized per-firing at the host cadence,
        # so scale increments by the number of host fine-tick firings
        # the window replaces (n_sub when the gate fires every fine
        # tick, n_sub*dt*rate when the gate period spans several fine
        # ticks). EXACTLY 1 on fine ticks (n_sub == 1), whatever
        # dt*rate is — the host law is per-firing-unscaled there.
        g_ctrl = max(1.0, n_sub * min(1.0, c.dt * c.control_rate))
        g_pctrl = max(1.0, n_sub * min(1.0, c.dt * c.pitch_control_rate))
        pump_new = _sat(100 * u1_in + u1c * g_ctrl / c.control_rate,
                        0, 75)
        # leg params in the host unpacking order
        a1, a2, a3 = leg[1], leg[2], leg[3]

        # FlatDive: theta_d = 0 (:884-900)
        th_fd = jnp.asarray(0.0, dtype)
        # Swim: theta_d = 0.1, bearing -> (bias, amp) (:902-934)
        th_sw = jnp.asarray(0.1, dtype)
        rho2 = jnp.hypot(wypnt[1] - st["last_fix"][1],
                         wypnt[0] - st["last_fix"][0])
        bearing = jnp.arctan2(wypnt[1] - st["last_fix"][1],
                              wypnt[0] - st["last_fix"][0])
        heading_err = _yaw_correction(yaw_m, bearing)
        sw_bias = _sat(3 * jnp.rad2deg(heading_err), -90, 90)
        sw_amp = jnp.where(
            rho2 > 0.5, jnp.asarray(math.degrees(a.tail_amp), dtype),
            100 * rho2 * a.tail_amp / 50 * (jnp.cos(heading_err) > 0))
        # Glide: theta_d from theta_gd with surface gate (:958-981)
        theta_gd = a1
        th_gl = jnp.where(jnp.abs(theta_gd) < math.radians(45), -theta_gd,
                          -jnp.pi / 2 * jnp.sign(theta_gd) + theta_gd)
        th_gl = jnp.where(use_gps & (a2 < 0), 0.0, th_gl)
        gl_bias = _sat(jnp.rad2deg(_yaw_correction(yaw_m, bearing)),
                       st["tail_bias"] - c.max_bias_rate * dt,
                       st["tail_bias"] + c.max_bias_rate * dt)

        # pitch-gated mass law (FlatDive / Swim / Glide)
        theta_d = jnp.where(is_fd, th_fd,
                            jnp.where(is_sw, th_sw,
                                      jnp.where(is_gl, th_gl, 0.0)))
        u2c = _mass_spd_control(pitch_m, theta_d, st["pitch_x"][1],
                                gains_p)
        mass_new = _sat(100 * u0 + u2c * g_pctrl / c.pitch_control_rate,
                        0, 100)
        mass_fire_p = (is_fd | is_sw | is_gl) & p_gate
        st["mass_cmd"] = jnp.where(mass_fire_p, mass_new, st["mass_cmd"])
        st["tlast_p_ctrl"] = jnp.where(mass_fire_p, t_abs,
                                       st["tlast_p_ctrl"])

        # control-rate-gated laws
        # Spiral mass schedule (:948-953): a1=dz
        sp_mass = jnp.where(use_gps & (a1 < 0), 46.0,
                            jnp.where(a1 > 0, 35.0,
                                      jnp.where(a1 < 0, 60.0,
                                                st["mass_cmd"])))
        sp_mass_fire = is_sp & c_gate & ((use_gps & (a1 < 0))
                                         | (a1 > 0.1) | (a1 < 0))
        st["mass_cmd"] = jnp.where(sp_mass_fire, _sat(sp_mass, 0, 100),
                                   st["mass_cmd"])
        # surfacing trim (:983-988)
        trim = (is_none & (depth > c.at_surface * 0.5)
                & (t_abs - st["tlast_ctrl"] > 10.0 / c.control_rate))
        pump_fire = (is_fd | is_sw | is_sp | is_gl) & c_gate
        st["pump_cmd"] = jnp.where(
            pump_fire, pump_new,
            jnp.where(trim, _sat(100 * u1_in + 3, 0, 75),
                      st["pump_cmd"]))
        st["mass_cmd"] = jnp.where(trim, 46.0, st["mass_cmd"])
        st["tlast_ctrl"] = jnp.where(pump_fire | trim, t_abs,
                                     st["tlast_ctrl"])

        # tail writes: swim sets (bias, amp, freq); others zero amp; spiral
        # and glide set bias (:931-933, :953-954, :990-993 order)
        st["tail_amp"] = jnp.where(is_sw & c_gate, _sat(sw_amp, 0, 50),
                                   jnp.where(~is_sw, 0.0,
                                             st["tail_amp"]))
        st["tail_freq"] = jnp.where(is_sw & c_gate,
                                    jnp.asarray(a.tail_freq, dtype),
                                    st["tail_freq"])
        st["tail_bias"] = jnp.where(
            is_sw & c_gate, sw_bias,
            jnp.where(is_sp & c_gate, jnp.rad2deg(a2),
                      jnp.where(is_gl & c_gate, gl_bias,
                                st["tail_bias"])))

        err2 = ((st["px"] - tar[0])**2 + (st["py"] - tar[1])**2
                + (st["pz"] - tar[2])**2)
        out = dict(t=t_abs, truth=truth, vel=vel, xhat=st["xhat"],
                   sample_xh=sample_xh,
                   Pdiag=jnp.diagonal(st["xhat_P"]), blue=blue,
                   sample=sample, fid=fid, budget=st["budget"],
                   err2=err2, code=code, Phat=st["Phat"], vb=st["vb"])
        return st, out

    # -- the scan -------------------------------------------------------------
    def _fly_impl(self, plan: DevicePlan, carry, key, t_cap: int):
        c = self.cfg
        t0 = carry["t"]
        n_ticks = jnp.ceil(plan.t_end / c.dt).astype(jnp.int32) + 1

        def fine_step(st, i):
            st2, out = self._tick(st, plan, t0, key, i)
            alive = i < n_ticks
            st = jax.tree.map(lambda n, o: jnp.where(alive, n, o), st2, st)
            out["alive"] = alive
            out["sample"] &= alive
            return st, out

        stride = self.glide_stride
        if stride == 1:
            carry, logs = jax.lax.scan(fine_step, carry,
                                       jnp.arange(t_cap, dtype=jnp.int32))
            return carry, logs

        # multi-rate scan: the scan runs over MACRO steps of ``stride``
        # fine ticks. A window entirely inside one glide/flat-dive leg
        # (no waypoint crossing, fully alive) advances with ONE coarse
        # tick of stride*dt — same physics and estimator discretizations,
        # a longer step; everything else (swims, spirals, leg
        # transitions, the plan tail) takes the exact fine path. Glide-
        # dominated plans (the planner's long legs) cut the scan length
        # ~stride x. Logs still come back with one row per FINE tick
        # (coarse windows emit one live row + stride-1 dead rows), so
        # consumers (fly_log, the mission program) are layout-unchanged.
        # Note: under vmap the branch becomes a select (both sides
        # execute) — use stride=1 for batched flight ensembles.
        T = -(-t_cap // stride)
        leg_codes = jnp.where(
            jnp.arange(self.l_cap) < plan.n_legs, plan.legs[:, 0], -1.0)
        valid_wp = jnp.arange(self.w_cap) < plan.n_wp
        # the stride-1 scan truncates at t_cap exactly; macro windows
        # must honor the same capacity (T*stride can exceed t_cap)
        n_ticks = jnp.minimum(n_ticks, t_cap)

        def macro_step(st, m):
            i0 = m * stride
            tw0 = st["t"] + c.dt - t0          # first sub-tick's time
            tw1 = st["t"] + stride * c.dt - t0  # last sub-tick's time
            cnt0 = jnp.sum((tw0 > plan.wp[:, 3]) & valid_wp)
            cnt1 = jnp.sum((tw1 > plan.wp[:, 3]) & valid_wp)
            p_cnt = jnp.clip(cnt0 - 1, 0, jnp.maximum(plan.n_legs - 1, 0))
            code = jnp.where((tw0 <= plan.t_end) & (plan.n_legs > 0),
                             leg_codes[p_cnt], -1.0)
            dead = i0 >= n_ticks  # whole window past the plan: frozen
            # GLIDE only: the long quasi-steady segments. Flat dives
            # drive depth with per-tick pump action and swims oscillate
            # the tail — both need the host's fine control cadence
            # (measured: coarse flat dives inflate pump energy ~30%)
            coarse_ok = dead | ((cnt0 == cnt1) & (tw1 <= plan.t_end)
                                & (code == float(Leg.GLIDE))
                                & (i0 + stride <= n_ticks))

            def coarse(st):
                # one coarse tick covers the window; dead windows ride
                # this branch too (1 tick instead of stride) and freeze
                st2, out = self._tick(st, plan, t0, key, i0,
                                      n_sub=stride)
                st2 = jax.tree.map(
                    lambda n, o: jnp.where(~dead, n, o), st2, st)
                outs = jax.tree.map(
                    lambda x: jnp.broadcast_to(
                        x, (stride,) + jnp.shape(x)), out)
                live = (jnp.arange(stride) == 0) & ~dead
                outs = dict(outs, alive=live,
                            sample=outs["sample"] & live)
                return st2, outs

            def fine(st):
                rows = []
                for j in range(stride):
                    st, out = fine_step(st, i0 + j)
                    rows.append(out)
                return st, jax.tree.map(lambda *xs: jnp.stack(xs), *rows)

            return jax.lax.cond(coarse_ok, coarse, fine, st)

        carry, logs = jax.lax.scan(macro_step, carry,
                                   jnp.arange(T, dtype=jnp.int32))
        # flatten macro windows back to one row per fine tick (padded
        # rows past t_cap are dead: alive/sample False)
        logs = jax.tree.map(
            lambda x: x.reshape((T * stride,) + x.shape[2:]), logs)
        return carry, logs

    def fly(self, plan: DevicePlan, carry, key, t_cap: int):
        """Fly one plan: returns (new carry, per-tick logs dict). ``t_cap``
        is the static tick capacity; ticks past ``ceil(t_end/dt)+1`` are
        frozen (the host loop's exact length)."""
        return self._fly_jit(plan, carry, key, t_cap)

    # -- host-facing wrapper for tests/CLI ------------------------------------
    def fly_log(self, waypoints, legs, carry=None, seed: int = 0,
                t_cap: Optional[int] = None):
        """Host convenience: pack, fly, and unpack into numpy arrays
        mirroring hw.runtime.FlightLog's core fields."""
        plan = self.pack_plan(waypoints, legs)
        if carry is None:
            carry = self.init_carry(float(waypoints[0][0]),
                                    float(waypoints[0][1]))
        if t_cap is None:
            t_cap = int(math.ceil(float(waypoints[-1][3]) / self.cfg.dt)) + 1
        budget0 = float(carry["budget"])
        carry, logs = self.fly(plan, carry, jax.random.key(seed), t_cap)
        alive = np.asarray(logs["alive"])
        smp = np.asarray(logs["sample"])
        truth = np.asarray(logs["truth"])
        xh = np.asarray(logs["xhat"])
        t = np.asarray(logs["t"])
        samples = np.column_stack([
            t[smp], truth[smp], np.asarray(logs["sample_xh"])[smp],
            np.asarray(logs["blue"])[smp],
            np.asarray(logs["fid"])[smp].astype(float)])
        err2 = np.asarray(logs["err2"])[alive]
        return dict(
            carry=carry,
            truth=np.column_stack([t[alive], truth[alive],
                                   np.asarray(logs["vel"])[alive]]),
            estimates=np.column_stack([t[alive], xh[alive],
                                       np.asarray(logs["Pdiag"])[alive]]),
            samples=samples,
            budget_used=float(carry["budget"]),
            plan_budget=float(carry["budget"]) - budget0,
            tracking_rmse=float(np.sqrt(err2.mean())) if err2.size else 0.0)
