"""
Lattice planner: polynomial lateral path sampling over the DP environment
+ longitudinal DP over the sampled path, replanned on a time/deviation
reinit policy. (reference: library/tpl/planning/dyn_prog/lattice_planner.py)

The reference version is unregistered WIP (commented out of
planning/__init__.py:19): its default branch needs a `DynProgLatPlanner`
that exists nowhere in the reference bindings and crashes on an undefined
`dp_params` (lattice_planner.py:251).  Its one coherent configuration —
`use_lat_sampling_planner=True`: PolyLatPlanner path + DP velocity profile
(lattice_planner.py:155-247,495) — is what this driver implements, reusing
the device kernels shared with PolyLatDpLonPlanner.  What distinguishes it
from that planner is the replan policy (lattice_planner.py:397-434): a
full replan from a warm start interpolated out of the stored lateral
polynomial every `reinit_time` seconds, and a cold reinit from the vehicle
when it strays more than `d_reinit_lat` off the planned path — instead of
the 10 Hz splice-and-extend loop.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu import util
from tpl_tpu.util import Bundle, snapshot
from tpl_tpu.ops.interp import lerp_xs
from tpl_tpu.environment import EnvironmentState
from tpl_tpu.planning.base_planner import BasePlanner
from tpl_tpu.planning.trajectory import Trajectory
from tpl_tpu.planning.utils import traj_collision_imminent
from tpl_tpu.planning.replan_policy import (
    ReplanPolicy, EmergencyLatch, snapshot_env, pass_gate,
    trajectory_from_array,
)
from tpl_tpu.planning.dyn_prog.dp_env import DpEnv
from tpl_tpu.planning.dyn_prog import lon_kernel as lk
from tpl_tpu.planning.dyn_prog.lon_kernel import (
    LonParams, lon_traj_state, LC_T, LC_S, LC_V, LC_A, LC_CONSTR,
    PC_X, PC_Y, PC_S, PC_L, PC_K, PC_VMAX, PC_DIST,
)
from tpl_tpu.planning.dyn_prog.poly_lat_kernel import (
    PolyLatParams, PolyLatTraj,
    TC_L, TC_DL, TC_DDL, TC_S, TC_V, TC_X, TC_Y, TC_H, TC_DIST, TC_K,
)
from tpl_tpu.planning.dyn_prog.poly_chain_kernel import (
    ChainRunner, KEEP_CAP,
)


class Params:
    """(lattice_planner.py:29-48; the dead DynProgLatPlanner knobs are
    dropped with the dead branch)"""

    def __init__(self):
        self.update_always = False
        self.write_debug_data = True

        self.dead_time = 0.0

        self.a_lat_max = 2.5

        self.d_reinit_lat = 0.2
        self.reinit_time = 1.0
        # bounded emergency/imminent retry cadence (see dp_lat_lon's
        # check_replan): a pinned emergency must not force a full
        # solve on every 10 ms pass
        self.emergency_retry_interval = 0.1

        self.lat_sampling = PolyLatParams()
        self.dyn_prog = LonParams()


class LatticePlanner(BasePlanner):

    RENDERER = "tpl_tpu.gui.renderers:poly_lat_dp_lon"

    def __init__(self, shared, lock_shared):
        np.seterr(divide="ignore", invalid="ignore")

        self.shared = shared
        self.lock_shared = lock_shared

        # plans may stay invalid for a few passes (the next replan
        # usually repairs them) before the emergency latch engages
        self.latch = EmergencyLatch(cycles=50, tolerance=10)
        self.policy = ReplanPolicy()   # policy.last_replan_time doubles
                                       # as this planner's reinit clock

        self.last_update_time = -1.0

        self.traj_lat = None          # PolyLatTraj
        self.path = None              # (P, 7) PathState array
        self.traj_lon = None          # (T, 7) lon states

        self.trajectory = Trajectory()
        self.trajectory_np = None

        self.lat_start = dict(l=0.0, dl=0.0, ddl=0.0, s=0.0, v=0.0)
        self.lon_start = np.zeros(7)

        # lattice rampifies over the path step (reference parity)
        self.chain = ChainRunner(rampify_step_path=True)

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
        """(lattice_planner.py:639-662)"""
        veh = env.vehicle_state
        with self.lock_shared():
            params = self.shared.params.planner
            length_veh = veh.rear_axis_to_front + veh.rear_axis_to_rear
            params.lat_sampling.length_veh = length_veh
            params.lat_sampling.width_veh = veh.width
            params.dyn_prog.length_veh = length_veh
            params.dyn_prog.width_veh = veh.width
            # full replans re-anchor trajectory time at the replan
            # instant, so the lon grid needs no fractional alignment
            params.dyn_prog.dt_start = params.dyn_prog.dt
            sh_params = snapshot(params)
        return sh_params

    def _path_dist_sl(self, cpp_lon):
        S = cpp_lon.s_steps
        dists = np.arange(S) * cpp_lon.s_step
        a = dists / cpp_lon.path_step_size
        i0 = np.clip(np.floor(a).astype(int), 0, len(self.path) - 1)
        i1 = np.clip(np.ceil(a).astype(int), 0, len(self.path) - 1)
        al = np.clip(a - i0, 0.0, 1.0)[:, None]
        interp = self.path[i0] * (1.0 - al) + self.path[i1] * al
        return interp[:, [PC_S, PC_L]]

    # ------------------------------------------------------------------

    def check_reinit(self, env, params):
        """Replan decision; returns (replan, from_traj).
        (lattice_planner.py:397-434: force/reset/no-state -> cold reinit;
        t since last reinit >= reinit_time -> warm reinit from the stored
        lateral polynomial; off-path by > d_reinit_lat -> cold reinit)"""
        veh = env.vehicle_state
        pol = self.policy

        if not veh.automated:
            return True, False

        reset_required = pol.reset_changed(env)
        if reset_required or self.traj_lon is None \
                or self.dp_env.ref_line is None:
            return True, False

        if self.trajectory.emergency:
            # bounded emergency-recovery cadence (dp_lat_lon pattern)
            if pol.due(env.t, min(params.reinit_time,
                                  params.emergency_retry_interval)):
                return True, False
            return False, False

        if pol.off_plan_lateral(util.project, self.path[:, :2],
                                (veh.x, veh.y), params.d_reinit_lat):
            return True, False

        if env.t - pol.last_replan_time >= params.reinit_time:
            return True, True

        if not self.is_traj_valid(self.traj_lon):
            return True, True

        # conservative host screen of the stored plan against the latest
        # predictions; a hit pulls the next warm replan forward (the
        # reference's current_traj_valid device reeval is commented-out
        # WIP, lattice_planner.py:668-671).  Rate-limited on the
        # screen's own clock so a persistent threat cannot force a
        # solve every pass (see ReplanPolicy.imminent_due)
        if (pol.imminent_due(env.t, min(params.reinit_time,
                                        params.emergency_retry_interval))
                and traj_collision_imminent(
                    self.trajectory_np, env.predicted,
                    params.dyn_prog.width_veh,
                    params.dyn_prog.length_veh, env.t)):
            return True, True

        return False, False

    def capture_warm_start(self, env, params):
        """Lateral warm start out of the stored lateral trajectory at the
        vehicle's station on the OLD reference line, captured before the
        env rebuild shifts the frame (lattice_planner.py:436-470)."""
        veh = env.vehicle_state
        s_cur = util.project(self.dp_env.ref_line[:, :2],
                             [veh.x, veh.y]).arc_len
        pts = self.traj_lat.points
        warm = {}
        for key, col in (("l", TC_L), ("dl", TC_DL), ("ddl", TC_DDL)):
            warm[key] = float(np.interp(s_cur, pts[:, TC_S], pts[:, col]))
        return warm

    def set_initial_state(self, env, params, lat_warm):
        """(lattice_planner.py:456-510). Projections run against the
        fresh reference line, so this follows the env rebuild."""
        veh = env.vehicle_state
        ref_proj = util.project(self.dp_env.ref_line[:, :2],
                                [veh.x, veh.y])
        t_traj = env.t - self.policy.last_replan_time

        if lat_warm is not None and self.traj_lon is not None:
            self.lat_start = dict(
                l=lat_warm["l"], dl=lat_warm["dl"], ddl=lat_warm["ddl"],
                s=ref_proj.arc_len, v=veh.v)
            lon = lon_traj_state(self.traj_lon, t_traj)
            self.lon_start = np.zeros(7)
            self.lon_start[LC_V] = lon[LC_V]
            self.lon_start[LC_A] = lon[LC_A]
        else:
            self.lat_start = dict(
                l=ref_proj.distance,
                dl=np.tan(veh.phi - ref_proj.angle),
                ddl=0.0,
                s=ref_proj.arc_len, v=veh.v)
            self.lon_start = np.zeros(7)
            # the reference snaps the cold lon start onto the value grid
            # (lattice_planner.py:505-506)
            self.lon_start[LC_V] = round(veh.v)
            self.lon_start[LC_A] = round(veh.a)
        self.lon_start[LC_A] = min(params.dyn_prog.a_max, max(
            params.dyn_prog.a_min, self.lon_start[LC_A]))

        self.policy.mark(env.t)

    def update_planner(self, env, params):
        """One full replan: lateral sampling -> path resample + velocity
        profile -> longitudinal DP (lattice_planner.py:155-247,566-580),
        as the fused device chain (poly_chain_kernel.py): three async
        dispatches, ONE batched host pull.  The lattice replan has no
        near-path splice (the lateral trajectory is replaced wholesale
        each reinit), so the splice prefix is empty."""
        start = time.perf_counter()
        cpp_lat = params.lat_sampling
        cpp_lon = params.dyn_prog
        # the chain's velocity profile caps lateral acceleration from
        # the lateral param set; mirror the driver-level knob into it
        cpp_lat.a_lat_abs_max = params.a_lat_max
        cppe = self.dp_env.cpp_env

        cppe.update()
        x_off, y_off = cppe.x_offset, cppe.y_offset
        veh = env.vehicle_state

        start_vec = np.array([
            self.lat_start["l"], self.lat_start["dl"],
            self.lat_start["ddl"], self.lat_start["s"],
            self.lat_start["v"]], np.float32)
        old_pts = np.zeros((KEEP_CAP, 12), np.float32)
        prev_pt = np.array([veh.x - x_off, veh.y - y_off], np.float32)

        new_pts, path, _il, _isd, cost, traj, arc = self.chain.replan(
            cppe, cpp_lat, cpp_lon, start_vec, old_pts, 0,
            self.lon_start, prev_pt)

        pts = new_pts.astype(np.float64)
        pts[:, TC_X] += x_off
        pts[:, TC_Y] += y_off
        self.traj_lat = PolyLatTraj(pts)
        self.traj_lat.update_time_dist_curv()
        self.traj_lat.cost = float(cost)

        self.path = path.astype(np.float64)
        self.path[:, PC_X] += x_off
        self.path[:, PC_Y] += y_off
        self.lon_start[LC_S] = float(arc)
        self.traj_lon = traj.astype(np.float64)

        # milliseconds, matching the reference's runtime_dp semantics
        self.runtime_dp = (time.perf_counter() - start) * 1000.0

    def update_trajectory(self, env, params):
        """(lattice_planner.py:308-339)"""
        cpp_lon = params.dyn_prog
        ts = np.arange(0.0, (cpp_lon.t_steps - 1) * cpp_lon.dt, 0.1)

        lon_states = lk.lon_traj_states(self.traj_lon, ts)
        # lon s is distance along the path; map it back to path states
        lat_states = self.traj_lat.lerp(
            lon_states[:, LC_S]
            + self.path[0, PC_DIST])

        traj_np = np.zeros((len(ts), 8))
        traj_np[:, 0] = ts + env.t + params.dead_time
        traj_np[:, 1] = lat_states[:, TC_S]
        traj_np[:, 2] = lat_states[:, TC_X]
        traj_np[:, 3] = lat_states[:, TC_Y]
        traj_np[:, 4] = lon_states[:, LC_V]
        traj_np[:, 5] = lon_states[:, LC_A]
        traj_np[:, 6] = lat_states[:, TC_H]
        traj_np[:, 7] = lat_states[:, TC_K]

        self.latch.note(self.is_traj_valid(self.traj_lon))

        traj = trajectory_from_array(traj_np, self.latch.active)
        if not traj.emergency:
            self.trajectory_np = traj_np
        self.trajectory = traj

    def write_debug_data(self, env, params):
        if not params.write_debug_data:
            return
        if self.traj_lon is None or self.traj_lat is None:
            return
        with self.lock_shared():
            dbg = self.shared.debug.planner
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
            replan, from_traj = self.check_reinit(env, params)

            # device work is concentrated on replan passes; in-between
            # passes are host-only (the reference rebuilds the env every
            # tick but only consumes it on replans — its device reeval is
            # disabled WIP, lattice_planner.py:668-676, so a per-tick
            # rebuild would only add device work)
            if replan or params.update_always:
                lat_warm = None
                if from_traj and self.traj_lat is not None:
                    lat_warm = self.capture_warm_start(env, params)
                self.dp_env.update(env, defer_device=True)
                self.set_initial_state(env, params, lat_warm)
                self.update_planner(env, params)
                self.dp_env.finish_deferred_update()
                self.update_trajectory(env, params)
            self.latch.decay()

            self.last_update_time = env.t

        self.write_debug_data(env, params)

        return self.trajectory
