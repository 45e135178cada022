"""
Polynomial lateral path planner: samples a (l_dst, s_dst) grid of quintic
lateral polynomials, evaluates per-arclength costs / times / collisions
against the DP environment, and selects the best path.

JAX re-design of the reference's five CUDA kernels (reference:
library/src/dyn_prog/poly_lat_planner.cu): the whole candidate tensor
(l_dst x s_dst x s) is evaluated at once; the quintic coefficient solves
for all candidates are one batched matrix product.

Candidate/selection layout mirrors PolyLatTrajPoint / path_nodes
(poly_lat_planner.cuh:64-108).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.ops.splines import PolyQuintic
from tpl_tpu.ops.interp import short_angle_dist, lerp_xs


# PolyLatTraj point columns
TC_T, TC_L, TC_DL, TC_DDL, TC_DDDL, TC_S, TC_V, TC_X, TC_Y, TC_H, \
    TC_DIST, TC_K = range(12)


class PolyLatParams:
    """(reference: poly_lat_planner.cuh:11-61)"""

    def __init__(self):
        self.l_min = -5.0
        self.l_max = 5.0
        self.s_min = 0.0
        self.s_max = 200.0
        self.s_steps = 201

        self.l_dst_min = -5.0
        self.l_dst_max = 5.0
        self.s_dst_min = 10.0
        self.s_dst_max = 70.0
        self.l_dst_steps = 21
        self.s_dst_steps = 13

        self.l_trg = 0.0

        self.w_l = 1.0
        self.w_k = 0.1
        self.w_dl = 0.0
        self.w_ddl = 0.0
        self.w_dddl = 1.0
        self.w_right = 0.0
        self.w_len = 0.0001

        self.k_abs_max = 1.0
        self.a_lat_abs_max = 2.5

        self.width_veh = 2.0
        self.length_veh = 2.0

    def dynamic_dict(self):
        return {k: jnp.float32(getattr(self, k)) for k in PL_PP_KEYS}

    def packed(self):
        """All dynamic params as ONE f32 vector: a single host->device
        transfer per call instead of one per scalar leaf."""
        return np.array([getattr(self, k) for k in PL_PP_KEYS],
                        dtype=np.float32)


PL_PP_KEYS = ("l_min", "l_max", "s_min", "s_max", "l_dst_min", "l_dst_max",
              "s_dst_min", "s_dst_max", "l_trg", "w_l", "w_k", "w_dl",
              "w_ddl", "w_dddl", "w_right", "w_len", "k_abs_max",
              "a_lat_abs_max", "width_veh", "length_veh")

ENV_PP_KEYS = ("dt_start", "dt", "s_min", "s_max", "l_min", "l_max")


def pack_env_pp(env_params):
    """DpEnvironment params -> packed f32 vector for occupancy lookups."""
    return np.array([getattr(env_params, k) for k in ENV_PP_KEYS],
                    dtype=np.float32)


def make_poly_lat_kernel(spec):
    """spec: s_steps, l_dst_steps, s_dst_steps, t_steps (env), + env grid
    sizes s_steps_env, l_steps_env for occupancy lookups."""
    S = spec["s_steps"]
    LD = spec["l_dst_steps"]
    SD = spec["s_dst_steps"]
    TE = spec["t_steps_env"]
    SE = spec["s_steps_env"]
    LE = spec["l_steps_env"]
    f32 = jnp.float32

    def ref_lerp(ref_line, ref_step, s):
        """Linear-interp ref line channels at s (RefLine::lerp)."""
        n = ref_line.shape[0]
        q = s / ref_step
        i0 = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
        i1 = jnp.clip(jnp.ceil(q), 0, n - 1).astype(jnp.int32)
        a = jnp.clip(q - i0, 0.0, 1.0)[..., None]
        return ref_line[i0] * (1.0 - a) + ref_line[i1] * a

    def occ_lookup(occ_map, env_pp, t, s, l):
        """interpDistField (env.cu:229-239): occupancy point lookup with
        the dt_start time mapping."""
        t_idx = jnp.where(t < env_pp["dt_start"], 0.0,
                          jnp.round((t - env_pp["dt_start"])
                                    / env_pp["dt"]) + 1.0)
        ti = jnp.clip(t_idx, 0, TE - 1).astype(jnp.int32)
        si = jnp.clip(jnp.round((s - env_pp["s_min"])
                                / (env_pp["s_max"] - env_pp["s_min"])
                                * (SE - 1)), 0, SE - 1).astype(jnp.int32)
        li = jnp.clip(jnp.round((l - env_pp["l_min"])
                                / (env_pp["l_max"] - env_pp["l_min"])
                                * (LE - 1)), 0, LE - 1).astype(jnp.int32)
        return occ_map[ti, si, li]

    @jax.jit
    def evaluate(occ_map, ref_line, ref_step, pp, env_pp, start):
        """start: [l, dl, ddl, s, v]. Returns per-candidate
        (collision_dist, traj_cost) arrays (LD, SD). pp / env_pp: dicts or
        packed f32 vectors (PolyLatParams.packed() / pack_env_pp())."""
        if not isinstance(pp, dict):
            pp = {k: pp[i] for i, k in enumerate(PL_PP_KEYS)}
        if not isinstance(env_pp, dict):
            env_pp = {k: env_pp[i] for i, k in enumerate(ENV_PP_KEYS)}
        l0, dl0, ddl0, s0, v0 = (start[0], start[1], start[2], start[3],
                                 start[4])

        l_dst = pp["l_dst_min"] + (pp["l_dst_max"] - pp["l_dst_min"]) \
            * jnp.arange(LD, dtype=f32) / max(LD - 1, 1)        # (LD,)
        s_dst = pp["s_dst_min"] + (pp["s_dst_max"] - pp["s_dst_min"]) \
            * jnp.arange(SD, dtype=f32) / max(SD - 1, 1)        # (SD,)
        s_step = (pp["s_max"] - pp["s_min"]) / (S - 1)
        ss = s0 + pp["s_min"] + jnp.arange(S, dtype=f32) * s_step  # (S,)

        # batched quintic coefficients for all (LD, SD) candidates
        x0b = jnp.broadcast_to(s0, (LD, SD))
        x1b = s0 + jnp.broadcast_to(s_dst[None, :], (LD, SD))
        poly = PolyQuintic(
            x0b, jnp.broadcast_to(l0, (LD, SD)),
            jnp.broadcast_to(dl0, (LD, SD)),
            jnp.broadcast_to(ddl0, (LD, SD)),
            x1b, jnp.broadcast_to(l_dst[:, None], (LD, SD)),
            jnp.zeros((LD, SD), f32), jnp.zeros((LD, SD), f32))

        sb = jnp.broadcast_to(ss[None, None, :], (LD, SD, S))
        past_end = sb >= (s0 + s_dst[None, :, None])
        l = jnp.where(past_end, l_dst[:, None, None],
                      poly.f(sb.transpose(2, 0, 1)).transpose(1, 2, 0))
        dl = jnp.where(past_end, 0.0,
                       poly.df(sb.transpose(2, 0, 1)).transpose(1, 2, 0))
        ddl = jnp.where(past_end, 0.0,
                        poly.ddf(sb.transpose(2, 0, 1)).transpose(1, 2, 0))
        dddl = jnp.where(past_end, 0.0,
                         poly.dddf(sb.transpose(2, 0, 1)).transpose(1, 2, 0))

        rp = ref_lerp(ref_line, ref_step, ss)                    # (S, 8)
        rp_x, rp_y, rp_h, rp_k = rp[:, 0], rp[:, 1], rp[:, 2], rp[:, 3]
        rp_v, rp_dl, rp_dr = rp[:, 4], rp[:, 5], rp[:, 6]

        heading_frenet = jnp.arctan(dl)
        x = rp_x[None, None, :] - jnp.sin(rp_h)[None, None, :] * l
        y = rp_y[None, None, :] + jnp.cos(rp_h)[None, None, :] * l
        k = ((ddl / (dl * dl + 1.0) + rp_k[None, None, :])
             * jnp.cos(heading_frenet) / (1.0 - l * rp_k[None, None, :]))

        k_abs_path = jnp.maximum(jnp.abs(k), jnp.abs(rp_k)[None, None, :])
        v = jnp.where(k_abs_path > 1e-6,
                      jnp.minimum(rp_v[None, None, :],
                                  jnp.sqrt(pp["a_lat_abs_max"]
                                           / jnp.maximum(k_abs_path, 1e-9))),
                      rp_v[None, None, :])

        # local constraints (poly_lat_planner.cu:64-76)
        constr = jnp.maximum(
            0.0, jnp.minimum(rp_v[None, None, :], v0) ** 2 * jnp.abs(k)
            - pp["a_lat_abs_max"])
        in_poly = sb <= (s0 + s_dst[None, :, None])
        margin = pp["width_veh"] * 0.5 * np.sqrt(2.0)
        constr += jnp.where(in_poly, jnp.maximum(
            0.0, jnp.abs(k) - pp["k_abs_max"]), 0.0)
        constr += jnp.where(in_poly, jnp.maximum(
            0.0, l - (rp_dl[None, None, :] - margin)), 0.0)
        constr += jnp.where(in_poly, jnp.maximum(
            0.0, (-rp_dr[None, None, :] + margin) - l), 0.0)

        # local cost (poly_lat_planner.cu:78-92)
        cost = (pp["w_dl"] * dl ** 2 + pp["w_ddl"] * ddl ** 2
                + pp["w_dddl"] * dddl ** 2)
        cost += jnp.where(jnp.abs(k) > jnp.abs(rp_k)[None, None, :],
                          pp["w_k"] * k ** 2, 0.0)
        cost += 10e6 * constr

        # path times (poly_lat_planner.cu:102-148)
        dx = jnp.diff(x, axis=-1)
        dy = jnp.diff(y, axis=-1)
        d = jnp.sqrt(dx * dx + dy * dy)
        dt_seg = d / jnp.maximum(1.0, v[..., 1:])
        t = jnp.concatenate([jnp.zeros((LD, SD, 1), f32),
                             jnp.cumsum(dt_seg, axis=-1)], axis=-1)

        # collision checks (poly_lat_planner.cu:150-185)
        dist_sem = jnp.zeros((LD, SD, S), f32)
        for t_sweep in (-1.0, 0.0, 1.0):
            for dl_off in (0.0, 0.25, -0.25):
                dist_sem = jnp.maximum(dist_sem, occ_lookup(
                    occ_map, env_pp, t + t_sweep, sb, l + dl_off))
        collision = dist_sem > 0.0
        coll_z = jnp.where(collision & (t < 8.0)
                           & (sb > pp["length_veh"]), sb, 10000.0)

        # aggregate (poly_lat_planner.cu:187-225)
        traj_cost = jnp.sum(cost, axis=-1)
        collision_dist = jnp.minimum(jnp.min(coll_z, axis=-1), 1000.0)

        traj_cost += jnp.where(l_dst[:, None] < -0.1, pp["w_right"], 0.0)
        traj_cost += pp["w_l"] * (l_dst[:, None] - pp["l_trg"]) ** 2
        traj_cost += pp["w_len"] * jnp.abs(s_dst[None, :])

        return collision_dist, traj_cost

    return evaluate


def select_path(collision_dist, traj_cost, length_veh, l_dst_steps,
                s_dst_steps):
    """Sequential best-path selection (poly_lat_planner.cu:227-268).
    Host-side: 273 candidates, order-dependent scan."""
    cd = np.asarray(collision_dist)
    tc = np.asarray(traj_cost)
    min_idx_l = min(l_dst_steps // 2 + 1, l_dst_steps - 1)
    min_idx_s = s_dst_steps - 1
    max_cd = cd[min_idx_l, min_idx_s]
    min_cost = np.inf

    for il in range(l_dst_steps):
        for isd in range(s_dst_steps):
            if tc[il, isd] >= 1e6:
                continue
            if cd[il, isd] > max_cd + length_veh:
                max_cd = cd[il, isd]

    for il in range(l_dst_steps):
        for isd in range(s_dst_steps):
            if abs(cd[il, isd] - max_cd) > 1.0:
                continue
            if tc[il, isd] < min_cost:
                min_cost = tc[il, isd]
                max_cd = cd[il, isd]
                min_idx_l = il
                min_idx_s = isd

    return min_idx_l, min_idx_s


class PolyLatTraj:
    """Lateral trajectory: points (N, 12), see TC_* columns.
    (reference: poly_lat_planner.cuh:78-92, poly_lat_planner.cu:271-333)"""

    def __init__(self, points=None):
        self.points = points if points is not None else np.zeros((1, 12))
        self.cost = 0.0

    def copy(self):
        t = PolyLatTraj(self.points.copy())
        t.cost = self.cost
        return t

    def lerp(self, distance):
        """Vectorized interp by the distance column."""
        d = self.points[:, TC_DIST]
        distance = np.atleast_1d(np.asarray(distance, dtype=np.float64))
        idx = np.clip(np.searchsorted(d, distance, side="right") - 1,
                      0, max(len(d) - 2, 0))
        j = np.minimum(idx + 1, len(d) - 1)
        denom = np.maximum(d[j] - d[idx], 1e-9)
        a = np.clip((distance - d[idx]) / denom, 0.0, 1.0)[:, None]
        res = self.points[idx] * (1.0 - a) + self.points[j] * a
        res[:, TC_H] = self.points[idx, TC_H] + short_angle_dist(
            self.points[idx, TC_H], self.points[j, TC_H]) * a[:, 0]
        return res

    def lerp_one(self, distance):
        return self.lerp([distance])[0]

    def insert_after_station(self, s, other):
        """Keep points with s < given station, append other's points.
        (poly_lat_planner.cu:297-310)"""
        keep = self.points[self.points[:, TC_S] < s]
        self.points = np.vstack([keep, other.points])
        self.update_time_dist_curv()

    def update_time_dist_curv(self):
        """(poly_lat_planner.cu:312-333)"""
        p = self.points
        n = len(p)
        if n < 2:
            return
        dx = np.diff(p[:, TC_X])
        dy = np.diff(p[:, TC_Y])
        d = np.hypot(dx, dy)
        p[:-1, TC_K] = short_angle_dist(p[:-1, TC_H], p[1:, TC_H]) \
            / np.maximum(d, 1e-9)
        p[-1, TC_K] = p[-2, TC_K]
        p[:, TC_DIST] = np.concatenate([[0.0], np.cumsum(d)])
        dt_seg = d / np.maximum(p[:-1, TC_V], 1e-9)
        p[:, TC_T] = np.concatenate([[0.0], np.cumsum(dt_seg)])


class PolyLatPlannerJax:
    """Stateful wrapper mirroring the reference PolyLatPlanner API."""

    def __init__(self):
        self.params = PolyLatParams()
        self._kernel = None
        self._spec = None

    def reinit_buffers(self, params):
        self.params = params

    def _get_kernel(self, env):
        ep = env.params
        spec = dict(s_steps=self.params.s_steps,
                    l_dst_steps=self.params.l_dst_steps,
                    s_dst_steps=self.params.s_dst_steps,
                    t_steps_env=ep.t_steps, s_steps_env=ep.s_steps,
                    l_steps_env=ep.l_steps)
        if self._spec != spec:
            self._kernel = make_poly_lat_kernel(spec)
            self._spec = spec
        return self._kernel

    def update(self, start, env):
        """start: dict/array-like with l, dl, ddl, s, v. env: DpEnvironment.
        Returns PolyLatTraj."""
        p = self.params
        kernel = self._get_kernel(env)

        start_vec = jnp.asarray([start["l"], start["dl"], start["ddl"],
                                 start["s"], start["v"]], jnp.float32)

        cd, tc = kernel(env.grid.occ_map, env.grid.ref_line,
                        jnp.float32(env.ref_step), p.packed(),
                        pack_env_pp(env.params), start_vec)
        il, isd = select_path(cd, tc, p.length_veh, p.l_dst_steps,
                              p.s_dst_steps)

        # expand winner on host (poly_lat_planner.cu:440-485)
        l_dst = p.l_dst_min + (p.l_dst_max - p.l_dst_min) \
            * il / max(p.l_dst_steps - 1, 1)
        s_dst = p.s_dst_min + (p.s_dst_max - p.s_dst_min) \
            * isd / max(p.s_dst_steps - 1, 1)

        s0 = float(start["s"])
        poly = PolyQuintic(s0, float(start["l"]), float(start["dl"]),
                           float(start["ddl"]), s0 + s_dst, l_dst, 0.0, 0.0)

        s_step = (p.s_max - p.s_min) / (p.s_steps - 1)
        ss = s0 + p.s_min + np.arange(p.s_steps) * s_step

        past = ss >= s0 + s_dst
        l = np.where(past, l_dst, np.asarray(poly.f(ss)))
        dl = np.where(past, 0.0, np.asarray(poly.df(ss)))
        ddl = np.where(past, 0.0, np.asarray(poly.ddf(ss)))
        dddl = np.where(past, 0.0, np.asarray(poly.dddf(ss)))

        rl = env.ref_line   # host (N, 8), offset-centered
        grid_s = np.arange(len(rl)) * env.ref_step
        rp_x = lerp_xs(ss, grid_s, rl[:, 0])
        rp_y = lerp_xs(ss, grid_s, rl[:, 1])
        rp_h = lerp_xs(ss, grid_s, rl[:, 2], angle=True)
        rp_v = lerp_xs(ss, grid_s, rl[:, 4])

        pts = np.zeros((p.s_steps, 12))
        pts[:, TC_S] = ss
        pts[:, TC_L] = l
        pts[:, TC_DL] = dl
        pts[:, TC_DDL] = ddl
        pts[:, TC_DDDL] = dddl
        heading_frenet = np.arctan(dl)
        pts[:, TC_X] = env.x_offset + rp_x - np.sin(rp_h) * l
        pts[:, TC_Y] = env.y_offset + rp_y + np.cos(rp_h) * l
        pts[:, TC_H] = heading_frenet + rp_h
        pts[:, TC_V] = rp_v

        traj = PolyLatTraj(pts)
        traj.update_time_dist_curv()
        traj.cost = float(tc[il, isd])
        return traj
