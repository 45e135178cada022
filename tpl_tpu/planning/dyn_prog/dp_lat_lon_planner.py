"""
3-D state-lattice value-iteration planner driver (FAS 2025): replan policy,
emergency latch, dead-time stitching, LQR trajectory smoothing, and
Frenet->Cartesian conversion around the device DP kernel.
(reference: library/tpl/planning/dyn_prog/dp_lat_lon_planner.py and the
post-processing in library/src/dyn_prog/lat_lon_planner.cu:645-825)
"""

import time
import copy

import numpy as np
import jax.numpy as jnp

from tpl_tpu import util
from tpl_tpu.util import Bundle
from tpl_tpu.ops import lqr_smoother, short_angle_dist
from tpl_tpu.ops.interp import lerp_xs
from tpl_tpu.environment import EnvironmentState
from tpl_tpu.planning.base_planner import BasePlanner
from tpl_tpu.planning.trajectory import Trajectory
from tpl_tpu.planning.utils import traj_collision_imminent
from tpl_tpu.planning.replan_policy import (
    ReplanPolicy, EmergencyLatch, snapshot_env, pass_gate, cog,
    stitch_dead_time, trajectory_from_array,
)
from tpl_tpu.planning.dyn_prog.dp_env import DpEnv
from tpl_tpu.planning.dyn_prog import lat_lon_kernel as llk
from tpl_tpu.planning.dyn_prog.lat_lon_kernel import (
    LatLonParams, latlon_dynamics_np,
    C_T, C_S, C_DS, C_DDS, C_DDDS, C_L, C_DL, C_DDL, C_DDDL,
    C_COST, C_CONSTR, C_FLAGS,
)
from tpl_tpu.util import snapshot


class Params:

    def __init__(self):
        self.write_debug_data = True
        self.update_always = False
        self.replan_time_step = 0.1
        self.dead_time = 0.0
        self.d_reinit = 2.0
        # retry cadence while the emergency latch holds (see
        # check_replan): bounded so a pinned latch cannot force a full
        # env+solve on every 10 ms pass
        self.emergency_retry_interval = 0.1
        self.cpp = LatLonParams()


def traj_state(traj, t):
    """Piecewise-dynamics evaluation of a frenet trajectory at time t.
    (lat_lon_planner.cu:425-434 LatLonTraj::state)"""
    ts = traj[:, C_T]
    i = int(np.clip(np.searchsorted(ts, t, side="right") - 1,
                    0, len(traj) - 1))
    t_rel = t - traj[i, C_T]
    return latlon_dynamics_np(traj[i], traj[i, C_DDS], traj[i, C_DL], t_rel)


def traj_states(traj, ts):
    """Vectorized :func:`traj_state` over a time grid ts -> (len(ts), 12)."""
    node_ts = traj[:, C_T]
    idx = np.clip(np.searchsorted(node_ts, ts, side="right") - 1,
                  0, len(traj) - 1)
    base = traj[idx]
    t_rel = ts - base[:, C_T]
    dds = base[:, C_DDS]
    dl = base[:, C_DL]
    out = base.astype(np.float64).copy()
    out[:, C_T] = base[:, C_T] + t_rel
    out[:, C_S] = np.maximum(
        base[:, C_S],
        base[:, C_S] + base[:, C_DS] * t_rel + 0.5 * dds * t_rel ** 2)
    out[:, C_DS] = np.maximum(0.0, base[:, C_DS] + dds * t_rel)
    out[:, C_DDS] = dds
    out[:, C_L] = base[:, C_L] + dl * t_rel
    out[:, C_DL] = dl
    out[:, C_DDL] = 0.0
    out[:, C_DDDS] = 0.0
    out[:, C_DDDL] = 0.0
    return out


def traj_lerp(traj, t):
    """Linear interp of all channels. (lat_lon_planner.cu:436-460)"""
    ts = traj[:, C_T]
    i = int(np.clip(np.searchsorted(ts, t, side="right") - 1,
                    0, len(traj) - 2)) if len(traj) > 1 else 0
    j = min(i + 1, len(traj) - 1)
    denom = max(ts[j] - ts[i], 1e-9)
    a = np.clip((t - ts[i]) / denom, 0.0, 1.0)
    return traj[i] * (1.0 - a) + traj[j] * a


class DpLatLonPlanner(BasePlanner):

    RENDERER = "tpl_tpu.gui.renderers:dp_lat_lon"

    def __init__(self, shared, lock_shared):
        np.seterr(divide="ignore", invalid="ignore")

        self.shared = shared
        self.lock_shared = lock_shared

        # invalid plans latch the emergency trajectory immediately: the
        # value grid itself judged every action constraint-violating
        self.latch = EmergencyLatch(cycles=50, tolerance=0)
        self.policy = ReplanPolicy()

        self.last_update_time = -1.0
        self.dt_start = None

        self.traj_dp = None           # (N, 12) frenet trajectory
        self.traj_smooth = np.zeros((1, 12))
        self.traj_smooth_cart = None

        self.trajectory = Trajectory()
        self.trajectory_np = None

        self._solver = None
        self._reeval = None
        self._solver_spec = None

        self.runtime_dp = 0.0
        self.runtime_smooth = 0.0

        with self.lock_shared():
            self.shared.params = Bundle()
            self.shared.params.planner = Params()
            self.shared.debug = Bundle()
            self.shared.debug.planner = Bundle()

        self.dp_env = DpEnv(shared, lock_shared)
        self.env = EnvironmentState()
        self.ref_proj = None

    # ------------------------------------------------------------------

    def is_traj_valid(self, traj):
        return bool(np.all(traj[1:, C_CONSTR] == 0))

    def update_params(self, env):
        veh = env.vehicle_state
        with self.lock_shared():
            params = self.shared.params.planner
            params.cpp.length_veh = veh.rear_axis_to_front + \
                veh.rear_axis_to_rear
            params.cpp.width_veh = veh.width

            dt_update = env.t - self.last_update_time
            if self.dt_start is None:
                self.dt_start = params.cpp.dt
            else:
                self.dt_start = (self.dt_start - dt_update) % params.cpp.dt
            params.cpp.dt_start = self.dt_start

            sh_params = snapshot(params)
        return sh_params

    def _get_solver(self, cpp):
        spec = dict(t_steps=cpp.t_steps, s_steps=cpp.s_steps,
                    ds_steps=cpp.ds_steps, l_steps=cpp.l_steps)
        if self._solver is None or self._solver_spec != spec:
            self._replan_fused, self._solver, self._reeval = \
                llk.make_latlon_replan(spec)
            self._solver_spec = spec
        return self._solver

    def _reeval_traj(self, cpp, traj):
        """Device re-evaluation of a stored trajectory: one dispatch plus
        one (N, 12) pull; the distance grid never leaves the device."""
        self._get_solver(cpp)
        grid = self.dp_env.cpp_env.grid
        out = self._reeval(grid.dist_map_lon, grid.ref_line,
                           jnp.float32(self.dp_env.cpp_env.ref_step),
                           cpp.packed(), jnp.asarray(traj, jnp.float32))
        return np.asarray(out, dtype=np.float64)

    # ------------------------------------------------------------------

    def update_planner(self, env, params, replan):
        cpp = params.cpp

        # spatio-temporal window from maneuver time constraints
        if len(env.man_time_cons) > 0:
            pos_st, t_st_min, t_st_max = env.man_time_cons[0]
            s_st = util.project(self.dp_env.ref_line[:, :2], pos_st).arc_len
            cpp.t_st_min = t_st_min - env.t - params.dead_time
            cpp.t_st_max = t_st_max - env.t - params.dead_time
            cpp.s_st = s_st
        else:
            cpp.t_st_min = 0.0
            cpp.t_st_max = 1000.0
            cpp.s_st = 0.0

        # match grid lateral range to the environment's fitted range
        cpp.l_min = self.dp_env.cpp_env.params.l_min
        cpp.l_max = self.dp_env.cpp_env.params.l_max

        if replan:
            self._get_solver(cpp)
            cpp_env = self.dp_env.cpp_env

            x0 = np.zeros(12, dtype=np.float32)
            x0[:] = self.traj_dp[0]

            # env grid build + DP solve as ONE device program; the grids
            # come back device-resident for debug / other consumers
            start = time.perf_counter()
            inputs = cpp_env.device_inputs()
            occ, dist_lon, traj = self._replan_fused(
                *inputs, cpp.packed(), jnp.asarray(x0))
            cpp_env.adopt_grid(occ, dist_lon)
            traj = np.asarray(traj, dtype=np.float64)
            self.runtime_dp = (time.perf_counter() - start) * 1000.0

            self.traj_dp = traj
            self.policy.mark(env.t)

        start = time.perf_counter()
        self.update_traj_smooth(params)
        self.update_traj_cart(params)
        self.runtime_smooth = (time.perf_counter() - start) * 1000.0

    def update_traj_smooth(self, params):
        """Resample at dt_smooth and LQR-smooth the s- and l-profiles with
        quadruple-integrator chains. (lat_lon_planner.cu:645-769)"""
        cpp = params.cpp
        dt_s = cpp.dt_smooth_traj

        resample_steps = int(self.traj_dp[-1, C_T] / dt_s)
        if resample_steps < 2:
            self.traj_smooth = self.traj_dp.copy()
            return
        ts = np.arange(resample_steps) * dt_s
        resampled = traj_states(self.traj_dp, ts)

        x_ref_s = np.zeros((resample_steps, 4))
        x_ref_s[:, 0] = resampled[:, C_S]
        x_ref_s[:, 1] = resampled[:, C_DS]
        x_ref_l = np.zeros((resample_steps, 4))
        x_ref_l[:, 0] = resampled[:, C_L]

        x0_s = self.traj_smooth[0][[C_S, C_DS, C_DDS, C_DDDS]]
        x0_l = self.traj_smooth[0][[C_L, C_DL, C_DDL, C_DDDL]]

        A = np.eye(4)
        A[0, 1] = dt_s
        A[1, 2] = dt_s
        A[2, 3] = dt_s
        B = np.zeros((4, 1))
        B[3, 0] = dt_s

        Q_s = np.diag([10.0, 10.0, 10.0, 10.0])
        Q_l = np.diag([1000.0, 10.0, 0.0, 0.0])
        R_s = np.array([[1.0]])
        R_l = np.array([[0.1]])

        xs_s, _ = lqr_smoother(x0_s, x_ref_s, A, B, Q_s, R_s)
        xs_l, _ = lqr_smoother(x0_l, x_ref_l, A, B, Q_l, R_l)

        sm = np.zeros((resample_steps, 12))
        sm[:, C_T] = ts
        sm[:, C_S] = xs_s[:, 0]
        sm[:, C_DS] = xs_s[:, 1]
        sm[:, C_DDS] = xs_s[:, 2]
        sm[:, C_DDDS] = xs_s[:, 3]
        sm[:, C_L] = xs_l[:, 0]
        sm[:, C_DL] = xs_l[:, 1]
        sm[:, C_DDL] = xs_l[:, 2]
        sm[:, C_DDDL] = xs_l[:, 3]
        self.traj_smooth = sm

    def update_traj_cart(self, params):
        """Frenet -> Cartesian with finite-difference curvature recovery.
        (lat_lon_planner.cu:771-825)"""
        cpp_env = self.dp_env.cpp_env
        rl = cpp_env.ref_line   # (N, 8) offset-centered
        step = cpp_env.ref_step
        traj = self.traj_smooth
        n = len(traj)

        s = traj[:, C_S]
        ss_grid = np.arange(len(rl)) * step
        x_r = lerp_xs(s, ss_grid, rl[:, 0])
        y_r = lerp_xs(s, ss_grid, rl[:, 1])
        h_r = lerp_xs(s, ss_grid, rl[:, 2], angle=True)
        k_r = lerp_xs(s, ss_grid, rl[:, 3])

        cart = np.zeros((n, 9))
        # cols: t, distance, x, y, v, a, heading, k, constr
        cart[:, 0] = traj[:, C_T]
        cart[:, 2] = cpp_env.x_offset + x_r - traj[:, C_L] * np.sin(h_r)
        cart[:, 3] = cpp_env.y_offset + y_r + traj[:, C_L] * np.cos(h_r)
        heading = np.where(traj[:, C_DS] < 1e-3, h_r,
                           np.arctan(traj[:, C_DL]
                                     / np.maximum(traj[:, C_DS], 1e-9))
                           + h_r)
        cart[:, 6] = heading
        cart[:, 4] = np.sqrt(
            ((1.0 - k_r * traj[:, C_L]) * traj[:, C_DS]) ** 2
            + traj[:, C_DL] ** 2)
        cart[:, 8] = traj[:, C_CONSTR]

        if n > 1:
            dx = np.diff(cart[:, 2])
            dy = np.diff(cart[:, 3])
            ds = np.hypot(dx, dy)
            cart[1:, 1] = np.cumsum(ds)
            dt_ = np.maximum(np.diff(cart[:, 0]), 1e-9)
            a = np.diff(cart[:, 4]) / dt_
            k = np.where(ds >= 1e-3,
                         short_angle_dist(cart[:-1, 6], cart[1:, 6])
                         / np.maximum(ds, 1e-9), 0.0)
            cart[:-1, 5] = a
            cart[-1, 5] = a[-1] if len(a) else 0.0
            cart[:-1, 7] = k
            cart[-1, 7] = k[-1] if len(k) else 0.0

        self.traj_smooth_cart = cart

    # ------------------------------------------------------------------

    def update_trajectory(self, env, params):
        """Dead-time stitching + emergency latch -> Trajectory.
        (dp_lat_lon_planner.py:150-188)"""
        traj_np = self.traj_smooth_cart.copy()
        traj_np[:, 0] += env.t + params.dead_time
        traj_np = stitch_dead_time(traj_np, self.trajectory_np, env.t,
                                   params.dead_time,
                                   params.cpp.dt_smooth_traj, angle_col=6)

        self.latch.note(self.is_traj_valid(self.traj_dp))

        self.trajectory_np = traj_np
        self.trajectory = trajectory_from_array(traj_np, self.latch.active)

    def reset_initial_state(self, veh, params):
        proj = util.project(self.dp_env.ref_line[:, :2], cog(veh))

        init = np.zeros(12)
        init[C_S] = proj.arc_len + veh.v * params.dead_time
        init[C_DS] = veh.v
        init[C_L] = self.ref_proj.distance

        if self.traj_dp is None or len(self.traj_dp) == 0:
            self.traj_dp = np.zeros((params.cpp.t_steps, 12))
        self.traj_dp[0] = init
        self.traj_smooth[0] = init
        self.trajectory_np = None

    def shift_trajectory(self, env, params):
        """Retime by dt_update. (dp_lat_lon_planner.py:205-229; the s
        de-shift is applied separately when the env frame moves, see
        :meth:`apply_ref_shift`)"""
        if self.traj_dp is None:
            return

        dt_update = env.t - self.last_update_time

        self.traj_dp[:, C_T] -= dt_update

        keep = self.traj_dp[self.traj_dp[:, C_T] > 0.0]
        head = traj_state(self.traj_dp, 0.0)
        self.traj_dp = np.vstack([head[None, :], keep])

        self.traj_smooth[0] = traj_lerp(self.traj_smooth, dt_update)
        self.traj_smooth[0, C_T] = 0.0

    def apply_ref_shift(self):
        """De-shift stored s-coordinates into the freshly rebuilt env
        frame (the ref line only moves when the env grid is rebuilt)."""
        if self.traj_dp is None:
            return
        self.traj_dp[:, C_S] -= self.dp_env.ref_line_shift
        self.traj_smooth[0, C_S] -= self.dp_env.ref_line_shift

    def check_replan(self, env, params):
        """Host-only replan decision; returns (replan, reset_needed).
        The state reset itself (reset_initial_state) is deferred until
        after the env rebuild since it projects onto the fresh ref line.
        (dp_lat_lon_planner.py:231-290)"""
        veh = env.vehicle_state
        self.ref_proj = util.project(env.local_map.path[:, :2],
                                     [veh.x, veh.y])
        pol = self.policy
        pol.tick_msg()

        if self.latch.active:
            # Emergency recovery retries at a bounded cadence, not the
            # tick rate: while the latch holds, the published plan is
            # already the emergency trajectory, and one 10 ms pass does
            # not change the environment materially.  Ungated, a pinned
            # latch (e.g. crossing traffic blocking every corridor at a
            # junction for seconds — jungingen_right seed 2) forced a
            # full env-build+DP-solve EVERY pass: measured 205 s of
            # wall per 2 s of sim on the host path before this gate.
            if pol.due(env.t, min(params.replan_time_step,
                                  params.emergency_retry_interval)):
                return True, True
            return False, False

        if not veh.automated and env.t - pol.last_replan_time >= 1.0:
            self.latch.clear()
            return True, True

        reset_required = pol.reset_changed(env)
        if self.traj_dp is None or reset_required:
            self.latch.clear()
            return True, True

        if (self.trajectory_np is not None
                and pol.off_plan_start(self.trajectory, veh,
                                       params.d_reinit)):
            return True, True

        if len(self.traj_dp) < params.cpp.t_steps:
            return True, False

        if pol.due(env.t, params.replan_time_step):
            return True, False

        # stored-trajectory validity is refreshed against the rebuilt
        # environment on every replan pass (reevalTraj before the warm
        # start in update()); between replans the check is host-only
        if not self.is_traj_valid(self.traj_dp):
            return True, False

        # per-pass reaction to NEW threats without a device round trip:
        # conservative host screen of the stored plan against the latest
        # predictions; a hit forces the replan early.  Rate-limited on
        # the screen's OWN clock (imminent_due): a PERSISTENT threat
        # (crossing traffic parked on the plan) must not force a full
        # solve every pass, and the gate must stay reachable between
        # regular replans — due(last_replan_time, replan_time_step)
        # would be shadowed by the cadence check above
        if (pol.imminent_due(env.t, params.emergency_retry_interval)
                and traj_collision_imminent(
                    self.trajectory_np, env.predicted,
                    params.cpp.width_veh,
                    params.cpp.length_veh, env.t)):
            return True, False

        return False, False

    def write_debug_data(self, t, params, veh):
        with self.lock_shared():
            dbg = self.shared.debug.planner
            dbg.reinit_msg = self.policy.reinit_msg
            dbg.runtime_dp = self.runtime_dp
            dbg.runtime_smooth = self.runtime_smooth
            if params.write_debug_data:
                dbg.traj_dp = None if self.traj_dp is None \
                    else self.traj_dp.copy()
                dbg.traj_smooth = self.traj_smooth.copy()
                dbg.traj_smooth_cart = None if self.traj_smooth_cart is None \
                    else self.traj_smooth_cart.copy()

    def update(self, sh_env):
        env = snapshot_env(sh_env, self.env)

        params = self.update_params(env)

        if env.t == self.last_update_time and not params.update_always:
            time.sleep(0.001)
        update_needed, self.last_update_time = pass_gate(
            env, self.last_update_time, params.update_always)

        if update_needed:
            self.shift_trajectory(env, params)
            replan, reset_needed = self.check_replan(env, params)

            # Device work (env grid build, trajectory re-evaluation, DP
            # solve) is concentrated on replan passes; in-between passes
            # are pure host stitching.  The reference re-evaluates every
            # loop pass; here the effective loop rate of the device
            # pipeline is the replan rate (worst-case reaction delay to a
            # newly-invalid trajectory is replan_time_step in both
            # designs).
            # No reevalTraj between replans: on a replan pass the solve
            # itself re-derives costs/validity against the fresh env, and
            # x0 only consumes the (unchanged) state channels — a separate
            # reeval would cost one extra device round trip for values the
            # solve immediately overwrites.
            if replan:
                # host prep only; the grid build fuses into the solve
                # program inside update_planner (one dispatch per replan)
                self.dp_env.update(env, defer_device=True)
                self.apply_ref_shift()
                if reset_needed:
                    self.reset_initial_state(env.vehicle_state, params)
            elif params.update_always:
                self.dp_env.update(env)
                self.apply_ref_shift()

            self.update_planner(env, params, replan)
            if replan:
                self.dp_env.finish_deferred_update()
            self.update_trajectory(env, params)

            self.last_update_time = env.t

        self.write_debug_data(env.t, params, env.vehicle_state)

        return self.trajectory
