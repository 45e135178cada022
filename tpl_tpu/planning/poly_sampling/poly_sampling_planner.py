"""
Frenet polynomial sampling planner (Werling et al. 2010): lateral quintics
x longitudinal quartics over a (T, d, v) grid, jerk/time/deviation costs,
obstacle hull checks.

Device-first re-design of the reference's C++ planner (reference:
library/src/poly_sampling.cpp, library/tpl/planning/poly_sampling/
poly_sampling_planner.py): the whole candidate grid is evaluated by one
jitted program (poly_kernel.py) returning just the winning trajectory;
``_eval_candidates`` below is the vectorized-numpy twin kept as the
oracle for kernel tests and as a no-JAX fallback.
"""

import copy
import time

import numpy as np
import jax

from tpl_tpu import util
from tpl_tpu.util import Bundle
from tpl_tpu.ops import (
    rampify_profile, curv_to_vel_profile, intersect_polygons_batch,
)
from tpl_tpu.ops.splines import PolyQuintic, PolyQuartic
from tpl_tpu.ops.interp import short_angle_dist, lerp_xs
from tpl_tpu.planning.base_planner import BasePlanner
from tpl_tpu.planning.poly_sampling import poly_kernel
from tpl_tpu.planning.trajectory import Trajectory
from tpl_tpu.util import snapshot


class PolySamplingParams:
    """(reference: poly_sampling.hpp:37-67)"""

    def __init__(self):
        self.dt = 0.2

        self.T_min = 4.0
        self.T_max = 5.0
        self.T_step = 1.0

        self.lane_width = 1.0
        self.d_step = 1.0

        self.v_samples = 1
        self.v_step = 1.0

        self.k_j = 0.1
        self.k_t = 0.1
        self.trg_d = 0.0
        self.k_d = 1.0
        self.k_v = 1.0
        self.k_lat = 1.0
        self.k_lon = 1.0

        self.k_overtake_right = 1.0

        self.a_max = 2.0
        self.k_max = 1.0

        self.rear_axis_to_rear = 0.0
        self.rear_axis_to_front = 0.0
        self.width_ego = 0.0


class Params:

    def __init__(self):
        self.a_min = -2.5
        self.a_max = 2.5
        self.j_min = -1.5
        self.j_max = 1.5
        self.max_lat_acc = 2.5
        self.path_sampling_step = 0.5
        self.path_length = 250
        self.poly_params = PolySamplingParams()


def candidate_grid(start, pp):
    """Flattened (d_end, T, v_end) sampling grid + step times.

    Host-side and tiny; its sizes are the static shapes the device
    kernel compiles for.  (reference: poly_sampling.cpp:37-64)
    """
    ds_cands = np.arange(-pp.lane_width, pp.lane_width, pp.d_step)
    Ts = np.arange(pp.T_min, pp.T_max, pp.T_step)

    v_start = round(start["s_d"] / pp.v_step) * pp.v_step
    tvs = np.arange(v_start - pp.v_step * pp.v_samples,
                    v_start + pp.v_step * pp.v_samples + pp.v_step / 2,
                    pp.v_step)

    n_steps = len(np.arange(0.0, pp.T_max, pp.dt))
    ts = np.arange(n_steps) * pp.dt

    D, Tn, V = len(ds_cands), len(Ts), len(tvs)
    di = np.repeat(ds_cands, Tn * V)
    Ti = np.tile(np.repeat(Ts, V), D)
    tv = np.tile(tvs, D * Tn)
    return di, Ti, tv, ts


def _eval_candidates_device(start, path, obstacles, pp, device="cpu"):
    """Evaluate the candidate grid in one jitted device program and pull
    only the winning (N,)-sized trajectory back.

    device="cpu" (the per-tick default) pins the dispatch to the host
    CPU backend: a single planner tick is a latency-bound ~300-candidate
    grid.  Batched candidate sweeps should pass device=None to keep the
    default (accelerator) placement, like the other latency-bound
    solvers (optim/solver.py device="cpu" pattern).
    """
    if device == "cpu":
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            return _eval_candidates_jit(start, path, obstacles, pp)
    return _eval_candidates_jit(start, path, obstacles, pp)


def _eval_candidates_jit(start, path, obstacles, pp):
    di, Ti, tv, ts = candidate_grid(start, pp)
    hulls, valid = poly_kernel.pack_obstacles(obstacles)
    run = poly_kernel.make_poly_sampling_kernel(
        len(di), len(ts), len(path), hulls.shape[0],
        hulls.shape[1] if hulls.shape[0] else 0)
    start_vec = np.array([start[k] for k in
                          ("d", "d_d", "d_dd", "s", "s_d", "s_dd")],
                         np.float32)
    packed, cost = jax.device_get(run(start_vec, di, Ti, tv, ts,
                                      np.asarray(path, np.float32),
                                      hulls, valid,
                                      poly_kernel.pack_pp(pp)))
    out = poly_kernel.unpack_result(packed, cost)
    out["t"] = ts
    return out


def _eval_candidates(start, path, obstacles, pp):
    """Evaluate the full candidate grid; returns best trajectory dict.

    Vectorized-numpy twin of the device kernel — the oracle for kernel
    tests and the no-JAX fallback.

    start: dict with d, d_d, d_dd, s, s_d, s_dd.
    path: (N, 6) [x, y, heading, s, k, v_max].
    (reference: poly_sampling.cpp:66-265)
    """
    di, Ti, tv, ts = candidate_grid(start, pp)
    C = len(di)
    n_steps = len(ts)

    lat = PolyQuintic(np.zeros(C), np.full(C, start["d"]),
                      np.full(C, start["d_d"]), np.full(C, start["d_dd"]),
                      Ti, di, np.zeros(C), np.zeros(C))
    lon = PolyQuartic(np.zeros(C), np.full(C, start["s"]),
                      np.full(C, start["s_d"]), np.full(C, start["s_dd"]),
                      Ti, tv, np.zeros(C))

    tb = ts[None, :]                     # (1, N) -> broadcast over C
    tc = np.broadcast_to(ts, (C, n_steps)).T  # (N, C)

    d = lat.f(tc).T                      # (C, N)
    d_d = lat.df(tc).T
    d_dd = lat.ddf(tc).T
    d_ddd = lat.dddf(tc).T
    s = lon.f(tc).T
    s_d = lon.df(tc).T
    s_dd = lon.ddf(tc).T
    s_ddd = lon.dddf(tc).T

    Jp = np.sum(d_ddd ** 2, axis=1)
    Js = np.sum(s_ddd ** 2, axis=1)
    Jright = np.sum(np.where(d < 0.0, -d, 0.0), axis=1)

    final_v_diff = 100.0 - s_d[:, -1]
    final_d = pp.trg_d - d[:, -1]

    cd = pp.k_j * Jp + pp.k_t * Ti + pp.k_d * final_d ** 2 \
        + pp.k_overtake_right * Jright
    cv = pp.k_j * Js + pp.k_t * Ti + pp.k_v * final_v_diff ** 2
    cf = pp.k_lat * cd + pp.k_lon * cv

    # cartesian conversion (poly_sampling.cpp:151-190)
    ref_s = path[:, 3]
    heading_frenet = np.arctan(d_d / np.where(s_d == 0, 1e-9, s_d))
    rx = lerp_xs(s, ref_s, path[:, 0])
    ry = lerp_xs(s, ref_s, path[:, 1])
    rh = lerp_xs(s, ref_s, path[:, 2], angle=True)
    rv = lerp_xs(s, ref_s, path[:, 5])

    x = rx - np.sin(rh) * d
    y = ry + np.cos(rh) * d
    yaw = heading_frenet + rh

    seg = np.hypot(np.diff(x, axis=1), np.diff(y, axis=1))
    curv = np.zeros_like(x)
    curv[:, :-1] = short_angle_dist(yaw[:, :-1], yaw[:, 1:]) \
        / np.maximum(seg, 1e-9)
    curv[:, -1] = curv[:, -2]

    # constraint penalties (poly_sampling.cpp:192-258)
    penalty = 10.0e6
    cost = cf.copy()
    cost += penalty * np.sum(np.maximum(0.0, np.abs(s_d) - rv), axis=1)
    cost += penalty * np.sum(np.maximum(0.0, np.abs(curv) - pp.k_max),
                             axis=1)
    cost += penalty * np.sum(np.maximum(0.0, np.abs(s_dd) - pp.a_max),
                             axis=1)
    cost += penalty * np.sum(np.maximum(0.0, np.abs(d) - 4.0), axis=1)

    # obstacle collision checks
    hull_ego = np.array([
        [-pp.rear_axis_to_rear, -pp.width_ego / 2],
        [pp.rear_axis_to_front, -pp.width_ego / 2],
        [pp.rear_axis_to_front, pp.width_ego / 2],
        [-pp.rear_axis_to_rear, pp.width_ego / 2]])

    if obstacles:
        # coarse circle prefilter, then ONE batched SAT program over all
        # near (candidate, step) poses per obstacle
        r_ego = np.max(np.linalg.norm(hull_ego, axis=1))
        for o in obstacles:
            hull_o = np.asarray(o["hull"])
            if len(hull_o) < 3:
                continue
            c_o = np.mean(hull_o, axis=0)
            r_o = np.max(np.linalg.norm(hull_o - c_o, axis=1))
            near = np.hypot(x - c_o[0], y - c_o[1]) < r_ego + r_o + 0.5
            ci, si = np.nonzero(near)
            if len(ci) == 0:
                continue
            cs, sn = np.cos(yaw[ci, si]), np.sin(yaw[ci, si])
            rot = np.stack([np.stack([cs, -sn], -1),
                            np.stack([sn, cs], -1)], -2)   # (M, 2, 2)
            hulls = np.einsum("ka,mba->mkb", hull_ego, rot) \
                + np.stack([x[ci, si], y[ci, si]], -1)[:, None, :]
            hits = intersect_polygons_batch(hulls, hull_o)
            np.add.at(cost, ci[hits], penalty)

    best = int(np.argmin(cost))
    return dict(t=ts, d=d[best], d_d=d_d[best], d_dd=d_dd[best],
                s=s[best], s_d=s_d[best], s_dd=s_dd[best],
                x=x[best], y=y[best], yaw=yaw[best], c=curv[best],
                ds=np.concatenate([seg[best], [0.0]]),
                cost=float(cost[best]))


class PolySamplingPlanner(BasePlanner):

    RENDERER = "tpl_tpu.gui.renderers:poly_sampling"

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared

        self.runtime = 0.0
        self.trajectory = Trajectory()
        self.poly_traj = None

        self.last_time = 0.0
        self.last_update_time = 0.0

        with self.lock_shared():
            self.shared.params = Params()

    def update(self, sh_env):
        with sh_env.lock():
            if sh_env.local_map is None:
                return self.trajectory
            env_t = sh_env.t
            veh = snapshot(sh_env.vehicle_state)
            cmap = snapshot(sh_env.local_map)
            tracks = sh_env.get_all_tracks()

        with self.lock_shared():
            params = snapshot(self.shared.params)
        pp = params.poly_params

        if self.last_time == env_t:
            time.sleep(0.001)
            return self.trajectory
        self.last_time = env_t

        pp.rear_axis_to_rear = veh.rear_axis_to_rear
        pp.rear_axis_to_front = veh.rear_axis_to_front
        pp.width_ego = veh.width + 1.0

        dt_replan = env_t - self.last_update_time
        if dt_replan < pp.dt:
            return self.trajectory

        start_time = time.perf_counter()

        ref_proj = util.project(cmap.path[:, :2], [veh.x, veh.y])
        path = util.resample_path(cmap.path, params.path_sampling_step,
                                  params.path_length,
                                  start_index=ref_proj.start,
                                  zero_vel_at_end=True)
        if path is None:
            return self.trajectory

        path[:, 5] = curv_to_vel_profile(path[:, 4], path[:, 5],
                                         params.max_lat_acc)
        path[:, 5] = rampify_profile(
            None, None, path[:, 5], params.a_min, params.a_max,
            params.j_min, params.j_max, 1.0,
            params.path_sampling_step)[:, 0]

        obstacles = [dict(hull=np.asarray(do.hull)) for do in tracks]

        if self.poly_traj is None:
            start = dict(d=ref_proj.distance, d_d=0.0, d_dd=0.0,
                         s=0.0, s_d=veh.v, s_dd=veh.a)
        else:
            idx = max(0, min(len(self.poly_traj["t"]) - 1,
                             int(dt_replan / pp.dt)))
            pt = self.poly_traj
            start = dict(d=pt["d"][idx], d_d=pt["d_d"][idx],
                         d_dd=pt["d_dd"][idx], s=0.0,
                         s_d=pt["s_d"][idx], s_dd=pt["s_dd"][idx])

        self.poly_traj = _eval_candidates_device(start, path, obstacles, pp)
        pt = self.poly_traj

        traj = Trajectory()
        traj.time = env_t + pt["t"]
        traj.x = pt["x"]
        traj.y = pt["y"]
        traj.s = np.concatenate([[0.0], np.cumsum(pt["ds"][:-1])])
        traj.velocity = pt["s_d"]
        traj.acceleration = pt["s_dd"]
        traj.orientation = pt["yaw"]
        traj.curvature = pt["c"]
        self.trajectory = traj

        with self.lock_shared():
            dbg = Bundle()
            dbg.x = pt["x"].copy()
            dbg.y = pt["y"].copy()
            dbg.cost = pt["cost"]
            self.shared.debug = dbg

        self.last_update_time = env_t
        self.runtime = time.perf_counter() - start_time
        return self.trajectory
