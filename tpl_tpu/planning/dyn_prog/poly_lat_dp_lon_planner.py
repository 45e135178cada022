"""
FAS 2025 planner: polynomial lateral path sampling (with near-path
splicing) -> curvature-limited velocity profile -> longitudinal DP over the
resulting path. (reference:
library/tpl/planning/dyn_prog/poly_lat_dp_lon_planner.py)
"""

import time
import copy

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu import util
from tpl_tpu.util import Bundle
from tpl_tpu.ops.interp import lerp_xs
from tpl_tpu.environment import EnvironmentState
from tpl_tpu.planning.base_planner import BasePlanner
from tpl_tpu.planning.trajectory import Trajectory
from tpl_tpu.planning.utils import traj_collision_imminent
from tpl_tpu.planning.replan_policy import (
    ReplanPolicy, EmergencyLatch, snapshot_env, pass_gate,
    stitch_dead_time, trajectory_from_array,
)
from tpl_tpu.planning.dyn_prog.dp_env import DpEnv
from tpl_tpu.planning.dyn_prog import lon_kernel as lk
from tpl_tpu.planning.dyn_prog.lon_kernel import (
    LonParams, lon_traj_state, LC_T, LC_S, LC_V, LC_A, LC_J, LC_COST,
    LC_CONSTR, PC_X, PC_Y, PC_S, PC_L, PC_K, PC_VMAX, PC_DIST,
)
from tpl_tpu.planning.dyn_prog.poly_lat_kernel import (
    PolyLatParams, PolyLatTraj,
    TC_T, TC_L, TC_DL, TC_DDL, TC_DDDL, TC_S, TC_V, TC_X, TC_Y, TC_H,
    TC_DIST, TC_K,
)
from tpl_tpu.planning.dyn_prog.poly_chain_kernel import (
    ChainRunner, KEEP_CAP,
)
from tpl_tpu.util import snapshot


class Params:

    def __init__(self):
        self.write_debug_data = True
        self.update_always = False
        self.replan_time_step = 0.1
        self.dead_time = 0.0

        self.dist_path_fix_min = 5.0
        self.dist_path_fix = 1.0

        self.d_reinit = 2.0
        self.emergency_retry_interval = 0.1

        self.cpp_lat = PolyLatParams()
        self.cpp_lon = LonParams()


class PolyLatDpLonPlanner(BasePlanner):

    RENDERER = "tpl_tpu.gui.renderers:poly_lat_dp_lon"

    def __init__(self, shared, lock_shared):
        np.seterr(divide="ignore", invalid="ignore")

        self.shared = shared
        self.lock_shared = lock_shared

        # plans may stay invalid for a few passes (the next replan
        # usually repairs them) before the emergency latch engages
        self.latch = EmergencyLatch(cycles=50, tolerance=10)
        self.policy = ReplanPolicy()

        self.last_update_time = -1.0
        self.dt_start = None

        self.ref_proj = None

        self.traj_lat = None          # PolyLatTraj
        self.path = None              # (P, 7) PathState array
        self.traj_lon = None          # (T, 7) lon states

        self.trajectory = Trajectory()
        self.trajectory_np = None
        self.traj_point_prev = np.zeros(2)

        self.poly_lat_start = dict(l=0.0, dl=0.0, ddl=0.0, s=0.0, v=0.0)
        self.dp_lon_start = np.zeros(7)

        self.chain = ChainRunner()

        self.runtime_dp = 0.0

        with self.lock_shared():
            self.shared.params = Bundle()
            self.shared.params.planner = Params()
            self.shared.debug = Bundle()
            self.shared.debug.planner = Bundle()

        self.dp_env = DpEnv(shared, lock_shared)
        self.env = EnvironmentState()

    # ------------------------------------------------------------------

    def is_traj_valid(self, traj):
        return bool(np.all(traj[1:-1, LC_CONSTR] < 0.1))

    def update_params(self, env):
        veh = env.vehicle_state
        with self.lock_shared():
            params = self.shared.params.planner
            length_veh = veh.rear_axis_to_front + veh.rear_axis_to_rear
            params.cpp_lat.length_veh = length_veh
            params.cpp_lat.width_veh = veh.width
            params.cpp_lon.length_veh = length_veh
            params.cpp_lon.width_veh = veh.width

            dt_update = env.t - self.last_update_time
            if self.dt_start is None:
                self.dt_start = params.cpp_lon.dt
            else:
                self.dt_start = (self.dt_start - dt_update) \
                    % params.cpp_lon.dt
            if self.dt_start == 0.0:
                self.dt_start = params.cpp_lon.dt
            params.cpp_lon.dt_start = self.dt_start

            sh_params = snapshot(params)
        return sh_params

    # ------------------------------------------------------------------

    def update_planner(self, env, params):
        """(poly_lat_dp_lon_planner.py:133-184)

        One replan pass = three async device dispatches (env grid build,
        lateral stage, longitudinal stage) and exactly ONE host sync: a
        single batched pull of the new lateral points, resampled path,
        lon trajectory and selection metadata at the end — the fused
        pipeline shape of the reference's GPU chain
        (poly_lat_planner.cu:365-440 + lon_planner.cu:328), rebuilt as
        chained XLA programs with device-resident intermediates (see
        poly_chain_kernel.py)."""
        start = time.perf_counter()
        cpp_lat = params.cpp_lat
        cpp_lon = params.cpp_lon
        cppe = self.dp_env.cpp_env

        # dispatch 1: env grid build (its own executable, as in
        # lat_lon_kernel.make_latlon_replan)
        cppe.update()
        x_off, y_off = cppe.x_offset, cppe.y_offset

        # host-known inputs of the device chain: the splice prefix (the
        # previous lateral trajectory's points below the splice station
        # — the same predicate insert_after_station applies on the host
        # copy), the lateral start state, and the previous trajectory
        # point for the lon start projection
        s0 = self.poly_lat_start["s"]
        old_pts = np.zeros((KEEP_CAP, 12), np.float32)
        n_keep = 0
        if self.traj_lat is not None:
            keep = self.traj_lat.points[
                self.traj_lat.points[:, TC_S] < s0]
            if len(keep) > KEEP_CAP:
                keep = keep[-KEEP_CAP:]
            n_keep = len(keep)
            kp = keep.astype(np.float32)
            kp[:, TC_X] -= x_off
            kp[:, TC_Y] -= y_off
            old_pts[:n_keep] = kp

        start_vec = np.array([
            self.poly_lat_start["l"], self.poly_lat_start["dl"],
            self.poly_lat_start["ddl"], s0, self.poly_lat_start["v"]],
            np.float32)
        self.traj_point_prev = np.array([
            lerp_xs(env.t + params.dead_time, self.trajectory_np[:, 0],
                    self.trajectory_np[:, 2]),
            lerp_xs(env.t + params.dead_time, self.trajectory_np[:, 0],
                    self.trajectory_np[:, 3])])
        prev_pt = (self.traj_point_prev
                   - np.array([x_off, y_off])).astype(np.float32)

        # dispatches 2+3 and the single batched pull
        new_pts, path, _il, _isd, cost, traj, arc = self.chain.replan(
            cppe, cpp_lat, cpp_lon, start_vec, old_pts, n_keep,
            self.dp_lon_start, prev_pt)

        # host bookkeeping from the pulled results (world frame)
        pts = new_pts.astype(np.float64)
        pts[:, TC_X] += x_off
        pts[:, TC_Y] += y_off
        new_traj_lat = PolyLatTraj(pts)
        new_traj_lat.update_time_dist_curv()
        new_traj_lat.cost = float(cost)
        if self.traj_lat is None:
            self.traj_lat = new_traj_lat
        else:
            self.traj_lat.insert_after_station(s0, new_traj_lat)

        self.path = path.astype(np.float64)
        self.path[:, PC_X] += x_off
        self.path[:, PC_Y] += y_off
        self.dp_lon_start[LC_S] = float(arc)
        self.traj_lon = traj.astype(np.float64)

        # milliseconds, matching the reference's runtime_dp semantics
        # (dp_lat_lon_planner.py:138-140) and the sibling drivers
        self.runtime_dp = (time.perf_counter() - start) * 1000.0
        self.policy.mark(env.t)

    def update_trajectory(self, env, params):
        """(poly_lat_dp_lon_planner.py:186-246)"""
        cpp_lon = params.cpp_lon
        ts = np.arange(0.0, (cpp_lon.t_steps - 1) * cpp_lon.dt, 0.1)

        lon_states = lk.lon_traj_states(self.traj_lon, ts)
        lat_states = self.traj_lat.lerp(lon_states[:, LC_S])

        traj_np = np.zeros((len(ts), 8))
        traj_np[:, 0] = ts + env.t + params.dead_time
        traj_np[:, 1] = lat_states[:, TC_S]
        traj_np[:, 2] = lat_states[:, TC_X]
        traj_np[:, 3] = lat_states[:, TC_Y]
        traj_np[:, 4] = lon_states[:, LC_V]
        traj_np[:, 5] = lon_states[:, LC_A]
        traj_np[:, 6] = lat_states[:, TC_H]
        traj_np[:, 7] = lat_states[:, TC_K]

        traj_np = stitch_dead_time(traj_np, self.trajectory_np, env.t,
                                   params.dead_time, 0.1, angle_col=6)

        self.latch.note(self.is_traj_valid(self.traj_lon))
        self.latch.decay()

        traj = trajectory_from_array(traj_np, self.latch.active)
        if not traj.emergency:
            self.trajectory_np = traj_np
        self.trajectory = traj

    def reset_initial_state(self, env, params):
        """(poly_lat_dp_lon_planner.py:248-295)"""
        veh = env.vehicle_state

        self.traj_lon = None
        self.traj_lat = None
        self.path = None
        self.trajectory_np = None

        ts = np.arange(0.0, 10.0, 0.1)
        self.trajectory_np = np.zeros((len(ts), 8))
        self.trajectory_np[:, 0] = ts + env.t
        self.trajectory_np[:, 1] = ts * veh.v
        self.trajectory_np[:, 2] = veh.x + np.cos(veh.phi) \
            * (ts * veh.v + veh.wheel_base * 0.5)
        self.trajectory_np[:, 3] = veh.y + np.sin(veh.phi) \
            * (ts * veh.v + veh.wheel_base * 0.5)
        self.trajectory_np[:, 4] = veh.v
        self.trajectory_np[:, 6] = veh.phi

        ref_proj = util.project(self.dp_env.ref_line[:, :2],
                                [veh.x, veh.y])
        self.poly_lat_start = dict(
            l=ref_proj.distance,
            dl=np.tan(veh.phi - ref_proj.angle),
            ddl=0.0,
            s=0.0,
            v=veh.v)

        self.dp_lon_start = np.zeros(7)
        self.dp_lon_start[LC_V] = veh.v
        self.dp_lon_start[LC_A] = min(params.cpp_lon.a_max,
                                      max(0.0, veh.a))

    def shift_trajectory(self, env, params):
        """(poly_lat_dp_lon_planner.py:297-330)"""
        if self.traj_lon is None:
            return

        shift = env.local_map.shift_idx_start_ref \
            * env.local_map.step_size_ref

        self.traj_lat.points[:, TC_S] -= shift
        self.traj_lat.points = self.traj_lat.points[
            self.traj_lat.points[:, TC_S] >= 0.0]
        if len(self.traj_lat.points) == 0:
            self.traj_lon = None
            return

        start_pt = self.traj_lat.lerp_one(
            params.dist_path_fix_min
            + params.dist_path_fix * env.vehicle_state.v)
        self.poly_lat_start = dict(
            l=start_pt[TC_L], dl=start_pt[TC_DL], ddl=start_pt[TC_DDL],
            s=start_pt[TC_S], v=env.vehicle_state.v)

        self.trajectory_np[:, 1] -= shift

        dt_update = env.t - self.last_update_time
        self.traj_lon[:, LC_T] -= dt_update
        keep = self.traj_lon[self.traj_lon[:, LC_T] > 0.0]
        head = lon_traj_state(self.traj_lon, 0.0)
        self.traj_lon = np.vstack([head[None, :], keep])

        self.dp_lon_start = self.traj_lon[0].copy()
        self.dp_lon_start[LC_A] = min(params.cpp_lon.a_max, max(
            params.cpp_lon.a_min, self.dp_lon_start[LC_A]))

    def check_replan(self, env, params):
        """Host-only replan decision; returns (replan, reset_needed).
        The state reset itself (reset_initial_state) is deferred until
        after the env rebuild since it projects onto the fresh ref line.
        (poly_lat_dp_lon_planner.py:332-392)"""
        veh = env.vehicle_state
        self.ref_proj = util.project(env.local_map.path[:, :2],
                                     [veh.x, veh.y])
        pol = self.policy
        pol.tick_msg()

        if not veh.automated:
            # the reference resets every pass while a driver is in
            # control, which empties traj_lon and forces a replan
            return True, True

        reset_required = pol.reset_changed(env)
        if self.traj_lon is None or reset_required:
            return True, True

        if self.trajectory.emergency:
            # bounded emergency-recovery cadence (see dp_lat_lon's
            # check_replan): a pinned emergency must not force a full
            # solve on every 10 ms pass
            if pol.due(env.t, min(params.replan_time_step,
                                  params.emergency_retry_interval)):
                return True, True
            return False, False

        if pol.off_plan_start(self.trajectory, veh, params.d_reinit):
            return True, True

        if len(self.traj_lon) < params.cpp_lon.t_steps:
            return True, False

        if pol.due(env.t, params.replan_time_step):
            return True, False

        # stored-trajectory validity is refreshed on every replan pass
        # (the lon solve re-derives costs/validity against the fresh
        # env); between replans the check is host-only -- see update()
        if not self.is_traj_valid(self.traj_lon):
            return True, False

        # per-pass reaction to NEW threats without a device round trip:
        # conservative host screen of the stored plan against the latest
        # predictions; a hit just forces the replan one pass early.
        # Rate-limited on the screen's own clock so a persistent threat
        # cannot force a full solve every 10 ms pass (see
        # ReplanPolicy.imminent_due)
        if (pol.imminent_due(env.t, params.emergency_retry_interval)
                and traj_collision_imminent(
                    self.trajectory_np, env.predicted,
                    params.cpp_lon.width_veh,
                    params.cpp_lon.length_veh, env.t)):
            return True, False

        return False, False

    def write_debug_data(self, t, params, veh):
        if not params.write_debug_data:
            return
        if self.traj_lon is None or self.traj_lat is None:
            return
        with self.lock_shared():
            dbg = self.shared.debug.planner
            dbg.traj_point_prev = self.traj_point_prev
            dbg.traj_lon = self.traj_lon.copy()
            dbg.traj_lat = self.traj_lat.points.copy()
            dbg.path = None if self.path is None else self.path.copy()
            dbg.runtime_dp = self.runtime_dp

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

            # Device work (env grid build, poly-lat sweep, lon DP solve)
            # is concentrated on replan passes; in-between passes are pure
            # host stitching, so the effective loop rate of the device
            # pipeline is the replan rate (worst-case reaction
            # delay to a newly-invalid trajectory is replan_time_step in
            # both designs, see dp_lat_lon_planner.py).
            if replan:
                self.dp_env.update(env, defer_device=True)
                if reset_needed:
                    self.reset_initial_state(env, params)
                self.update_planner(env, params)
                self.dp_env.finish_deferred_update()
            elif params.update_always:
                self.dp_env.update(env)
            self.update_trajectory(env, params)

            self.last_update_time = env.t

        self.write_debug_data(env.t, params, env.vehicle_state)

        return self.trajectory
