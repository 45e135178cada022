"""
Fused device replan chain for the PolyLatDpLonPlanner (FAS-2025 family).

An unfused chain makes four separately dispatched device programs per
replan with two synchronous host pulls in the middle (candidate
cost/collision pull for the host ``select_path``, plus a scalar cost
pull).  The reference runs the whole chain as one GPU pipeline with no
host round-trips mid-chain (reference: library/src/dyn_prog/
poly_lat_planner.cu:365-440 update + lon_planner.cu:328 updateTraj).

This module restores that shape: per replan,

  1. env grid build          (async dispatch, dp_environment._build_grids)
  2. lateral stage           (async dispatch): candidate sweep ->
     sequential best-path selection (exact twin of the host
     ``select_path`` order-dependent scan, as a fori_loop) -> winner
     expansion -> near-path splice with the previous lateral trajectory
     -> resampling into the lon planner's path -> curvature/jerk-limited
     velocity profile
  3. longitudinal stage      (async dispatch): previous-trajectory-point
     projection -> path distance map -> lon DP solve

with exactly ONE host synchronisation at the end (a single batched
``device_get`` of the new lateral points, the path, the lon trajectory
and the selection metadata).  The env build is still its own executable
(as in lat_lon_kernel.make_latlon_replan); its output stays on the
device and feeds the lateral stage directly.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tpl_tpu.ops.splines import PolyQuintic
from tpl_tpu.ops.interp import short_angle_dist
from tpl_tpu.ops.jgeometry import project_polyline
from tpl_tpu.planning.dyn_prog import lon_kernel as lk
from tpl_tpu.planning.dyn_prog import dp_environment as dpe
from tpl_tpu.planning.dyn_prog.lon_kernel import (
    LC_S, PC_S, PC_L, PC_K, PC_VMAX, unpack_lon_pp,
)
from tpl_tpu.planning.dyn_prog.poly_lat_kernel import (
    make_poly_lat_kernel, PL_PP_KEYS, ENV_PP_KEYS,
    TC_T, TC_L, TC_DL, TC_DDL, TC_DDDL, TC_S, TC_V, TC_X, TC_Y, TC_H,
    TC_DIST, TC_K,
)

f32 = jnp.float32

# capacity for the spliced previous-trajectory prefix (points with
# s < splice station); the station is dist_path_fix_min + dist_path_fix
# * v <= ~41 m at ~1 m spacing, so 128 rows is ample headroom
KEEP_CAP = 128


def _lerp_xs_dev(x, dx, ys, angle=False):
    """Device twin of ops.interp.lerp_xs over an equally spaced grid
    starting at 0: floor index clamped to [0, n-2], UNclamped alpha
    (linear extrapolation beyond the grid, like the host expansion)."""
    n = ys.shape[0]
    q = x / dx
    i0 = jnp.clip(jnp.floor(q), 0, n - 2).astype(jnp.int32)
    i1 = jnp.clip(jnp.ceil(q), 0, n - 1).astype(jnp.int32)
    a = q - i0
    if angle:
        return ys[i0] + short_angle_dist(ys[i0], ys[i1]) * a
    return ys[i0] * (1.0 - a) + ys[i1] * a


def select_path_device(collision_dist, traj_cost, length_veh,
                       l_dst_steps, s_dst_steps):
    """Exact in-program twin of poly_lat_kernel.select_path (reference:
    poly_lat_planner.cu:227-268): the two order-dependent scans over the
    (LD, SD) candidate grid, as fori_loops with the identical iteration
    order, compare order and f32 compares, so the fused chain picks the
    same winner as the host selection."""
    LD, SD = l_dst_steps, s_dst_steps
    # pin f32 regardless of caller dtype (x64 mode promotes the cost
    # tensor through numpy scalars in the candidate sweep)
    cd = collision_dist.reshape(-1).astype(f32)
    tc = traj_cost.reshape(-1).astype(f32)
    length_veh = jnp.asarray(length_veh, f32)
    init_l = min(LD // 2 + 1, LD - 1)
    init_s = SD - 1
    init_flat = init_l * SD + init_s
    max_cd0 = cd[init_flat]

    def pass1(i, max_cd):
        upd = (tc[i] < 1e6) & (cd[i] > max_cd + length_veh)
        return jnp.where(upd, cd[i], max_cd)

    max_cd = lax.fori_loop(0, LD * SD, pass1, max_cd0)

    def pass2(i, carry):
        mcd, min_cost, best = carry
        ok = (jnp.abs(cd[i] - mcd) <= 1.0) & (tc[i] < min_cost)
        return (jnp.where(ok, cd[i], mcd),
                jnp.where(ok, tc[i], min_cost),
                jnp.where(ok, i, best))

    _, min_cost, best = lax.fori_loop(
        0, LD * SD, pass2,
        (max_cd, jnp.asarray(jnp.inf, f32),
         jnp.asarray(init_flat, jnp.int32)))
    return best // SD, best % SD, min_cost


def _expand_winner(il, isd, start, ref_line, ref_step, pp, s_steps):
    """Winner expansion into (S, 12) lateral trajectory points, in the
    env's offset frame (device twin of PolyLatPlannerJax.update's host
    expansion; reference: poly_lat_planner.cu:440-485)."""
    S = s_steps
    l0, dl0, ddl0, s0 = start[0], start[1], start[2], start[3]

    LD = jnp.asarray(pp["_l_dst_steps"], f32)
    SD = jnp.asarray(pp["_s_dst_steps"], f32)
    l_dst = pp["l_dst_min"] + (pp["l_dst_max"] - pp["l_dst_min"]) \
        * il.astype(f32) / jnp.maximum(LD - 1, 1)
    s_dst = pp["s_dst_min"] + (pp["s_dst_max"] - pp["s_dst_min"]) \
        * isd.astype(f32) / jnp.maximum(SD - 1, 1)

    poly = PolyQuintic(s0, l0, dl0, ddl0, s0 + s_dst, l_dst,
                       jnp.zeros((), f32), jnp.zeros((), f32))
    s_step = (pp["s_max"] - pp["s_min"]) / (S - 1)
    ss = s0 + pp["s_min"] + jnp.arange(S, dtype=f32) * s_step

    past = ss >= s0 + s_dst
    # pin f32: the Hermite inverse matrix is f64 under x64 mode
    l = jnp.where(past, l_dst, poly.f(ss)).astype(f32)
    dl = jnp.where(past, 0.0, poly.df(ss)).astype(f32)
    ddl = jnp.where(past, 0.0, poly.ddf(ss)).astype(f32)
    dddl = jnp.where(past, 0.0, poly.dddf(ss)).astype(f32)

    rp_x = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_X])
    rp_y = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_Y])
    rp_h = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_H], angle=True)
    rp_v = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_V])

    pts = jnp.zeros((S, 12), f32)
    pts = pts.at[:, TC_S].set(ss)
    pts = pts.at[:, TC_L].set(l)
    pts = pts.at[:, TC_DL].set(dl)
    pts = pts.at[:, TC_DDL].set(ddl)
    pts = pts.at[:, TC_DDDL].set(dddl)
    pts = pts.at[:, TC_X].set(rp_x - jnp.sin(rp_h) * l)
    pts = pts.at[:, TC_Y].set(rp_y + jnp.cos(rp_h) * l)
    pts = pts.at[:, TC_H].set(jnp.arctan(dl) + rp_h)
    pts = pts.at[:, TC_V].set(rp_v)
    return pts


def _merge_and_time(old_pts, n_keep, new_pts):
    """Near-path splice: rows [0:n_keep] of the previous lateral
    trajectory followed by the freshly expanded points, then the masked
    twin of PolyLatTraj.update_time_dist_curv (reference:
    poly_lat_planner.cu:297-333).  Invalid tail rows get +inf DIST so the
    downstream distance-keyed resampling never selects them."""
    KP = old_pts.shape[0]
    S = new_pts.shape[0]
    M = KP + S
    idx = jnp.arange(M)
    valid = idx < n_keep + S
    old_idx = jnp.clip(idx, 0, KP - 1)
    new_idx = jnp.clip(idx - n_keep, 0, S - 1)
    merged = jnp.where((idx < n_keep)[:, None], old_pts[old_idx],
                       new_pts[new_idx])

    nxt = jnp.clip(idx + 1, 0, M - 1)
    # treat the last VALID row as its own successor (diffs become 0)
    last_valid = n_keep + S - 1
    nxt = jnp.minimum(nxt, last_valid)
    cur = jnp.minimum(idx, last_valid)
    p_cur = merged[cur]
    p_nxt = merged[nxt]

    dx = p_nxt[:, TC_X] - p_cur[:, TC_X]
    dy = p_nxt[:, TC_Y] - p_cur[:, TC_Y]
    d = jnp.hypot(dx, dy)
    k = short_angle_dist(p_cur[:, TC_H], p_nxt[:, TC_H]) \
        / jnp.maximum(d, 1e-9)
    # last row copies its predecessor's curvature (host twin)
    prv = jnp.clip(idx - 1, 0, M - 1)
    k = jnp.where(idx == last_valid, k[prv], k)
    merged = merged.at[:, TC_K].set(jnp.where(valid, k, 0.0))

    seg = jnp.where(idx < last_valid, d, 0.0)
    dist = jnp.concatenate([jnp.zeros(1, f32), jnp.cumsum(seg)[:-1]])
    dt_seg = jnp.where(idx < last_valid,
                       d / jnp.maximum(p_cur[:, TC_V], 1e-9), 0.0)
    t = jnp.concatenate([jnp.zeros(1, f32), jnp.cumsum(dt_seg)[:-1]])
    merged = merged.at[:, TC_DIST].set(jnp.where(valid, dist, jnp.inf))
    merged = merged.at[:, TC_T].set(jnp.where(valid, t, 0.0))
    return merged


def _traj_lerp(points, distance):
    """Device twin of PolyLatTraj.lerp: interpolation keyed on the DIST
    column (clamped, angle-aware heading)."""
    d = points[:, TC_DIST]
    n = points.shape[0]
    idx = jnp.clip(jnp.searchsorted(d, distance, side="right") - 1,
                   0, n - 2)
    j = jnp.minimum(idx + 1, n - 1)
    denom = jnp.maximum(d[j] - d[idx], 1e-9)
    a = jnp.clip((distance - d[idx]) / denom, 0.0, 1.0)[:, None]
    res = points[idx] * (1.0 - a) + points[j] * a
    res = res.at[:, TC_H].set(points[idx, TC_H] + short_angle_dist(
        points[idx, TC_H], points[j, TC_H]) * a[:, 0])
    return res


def curv_vel_device(k, lim_v, a_lat_max, k_eps=1e-6):
    """Device twin of ops.profile.curv_to_vel_profile."""
    ka = jnp.abs(k)
    v_curv = jnp.sqrt(a_lat_max / jnp.maximum(ka, 1e-30))
    return jnp.where(ka > k_eps, jnp.minimum(lim_v, v_curv), lim_v)


def rampify_device(lim_v, a_min, a_max, j_min, j_max, v_min, step):
    """Device twin of ops.profile.rampify_profile with v0=a0=None: the
    jerk/acc-limited backward+forward spatial velocity integration as two
    lax.scans (reference: library/tpl/planning/utils.py:6-65).  Returns
    the velocity channel only (the chain uses profile[:, 0])."""
    lim_v = jnp.maximum(lim_v, v_min)
    h = lim_v.shape[0]

    def bwd(carry, lim_prev_and_cur):
        cur_v, cur_a = carry
        lim_prev, lim_cur = lim_prev_and_cur
        out = (cur_v, cur_a)
        lim_a = jnp.maximum(a_min, (cur_v - lim_prev) / step * cur_v)
        neg = lim_a < 0.0
        cur_a = jnp.where(neg, jnp.maximum(cur_a + j_min / cur_v * step,
                                           lim_a), 0.0)
        cur_v = jnp.where(neg, cur_v, lim_cur)
        cur_v = cur_v + jnp.minimum(-cur_a / cur_v * step,
                                    lim_prev - cur_v)
        return (cur_v, cur_a), out

    # t = h-1 .. 1, reading lim_v[t-1] and lim_v[t]
    (v0, a0), tail = lax.scan(
        bwd, (lim_v[-1], jnp.zeros((), f32)),
        (lim_v[:-1][::-1], lim_v[1:][::-1]))
    prof_v = jnp.concatenate([v0[None], tail[0][::-1]])
    prof_a = jnp.concatenate([(-a0)[None], tail[1][::-1]])

    def fwd(carry, inp):
        cur_v, cur_a, lim_a = carry
        prof_t, prof_next, lim_t, is_last = inp
        lim_a = jnp.where(is_last, lim_a, jnp.minimum(
            a_max, (prof_next - cur_v) / step * cur_v))
        pos = lim_a > 0.0
        cur_a = jnp.where(pos, jnp.minimum(cur_a + j_max / cur_v * step,
                                           lim_a), 0.0)
        cur_v = jnp.where(pos, cur_v, prof_t)
        next_v = cur_v + jnp.minimum(cur_a / cur_v * step, lim_t - cur_v)
        cur_v = jnp.minimum(prof_t, next_v)
        return (cur_v, cur_a, lim_a), (cur_v, cur_a)

    prof_next = jnp.concatenate([prof_v[1:], prof_v[-1:]])
    is_last = jnp.arange(h) == h - 1
    _, (out_v, _) = lax.scan(
        fwd, (v0, -a0, jnp.zeros((), f32)),
        (prof_v, prof_next, lim_v, is_last))
    return out_v


def make_poly_chain(spec):
    """Build the fused lateral and longitudinal stage programs.

    spec keys: s_steps, l_dst_steps, s_dst_steps (lateral);
    t_steps_env, s_steps_env, l_steps_env (env grid); t_steps, s_steps_lon,
    v_steps, a_steps, path_steps (longitudinal).

    Returns (lat_stage, lon_stage), both jitted:

    lat_stage(occ_map, ref_line, ref_step, ppl, env_pp, ppn, start,
              old_pts, n_keep)
        -> (new_pts, merged, path, il, isd, cost)
    lon_stage(occ_map, path, env_scalars, ppn, x0, prev_pt)
        -> (traj, arc_len)
    """
    S_LAT = spec["s_steps"]
    LD = spec["l_dst_steps"]
    SD = spec["s_dst_steps"]
    P = spec["path_steps"]
    S_LON = spec["s_steps_lon"]
    # the FAS-2025 driver rampifies over a unit step (reference parity);
    # the lattice driver uses the path step
    rampify_step_path = bool(spec.get("rampify_step_path", False))

    evaluate = make_poly_lat_kernel(dict(
        s_steps=S_LAT, l_dst_steps=LD, s_dst_steps=SD,
        t_steps_env=spec["t_steps_env"], s_steps_env=spec["s_steps_env"],
        l_steps_env=spec["l_steps_env"]))
    lon_solve, _ = lk.make_lon_solver(dict(
        t_steps=spec["t_steps"], s_steps=S_LON, v_steps=spec["v_steps"],
        a_steps=spec["a_steps"], path_steps=P))

    @jax.jit
    def lat_stage(occ_map, ref_line, ref_step, ppl, env_pp, ppn, start,
                  old_pts, n_keep):
        """Candidate sweep -> selection -> expansion -> splice ->
        path resampling -> velocity profile.  ppl/env_pp/ppn are the
        packed f32 param vectors (PolyLatParams.packed(), pack_env_pp(),
        LonParams.packed())."""
        ppd = {k: ppl[i] for i, k in enumerate(PL_PP_KEYS)}
        ppd["_l_dst_steps"] = jnp.asarray(LD, f32)
        ppd["_s_dst_steps"] = jnp.asarray(SD, f32)
        ppn_d = unpack_lon_pp(ppn)

        cd, tc = evaluate(occ_map, ref_line, ref_step, ppl, env_pp, start)
        il, isd, cost = select_path_device(
            cd, tc, ppd["length_veh"], LD, SD)
        new_pts = _expand_winner(il, isd, start, ref_line, ref_step,
                                 ppd, S_LAT)
        merged = _merge_and_time(old_pts, n_keep, new_pts)

        dists = jnp.arange(P, dtype=f32) * ppn_d["path_step_size"]
        lat = _traj_lerp(merged, dists)
        path = lat[:, jnp.asarray([TC_X, TC_Y, TC_S, TC_L, TC_K, TC_V,
                                   TC_DIST])]
        v_prof = curv_vel_device(path[:, PC_K], path[:, PC_VMAX],
                                 ppd["a_lat_abs_max"])
        ramp_step = ppn_d["path_step_size"] if rampify_step_path else 1.0
        v_prof = rampify_device(v_prof, ppn_d["a_min"], ppn_d["a_max"],
                                ppn_d["j_min"], ppn_d["j_max"], 1.0,
                                ramp_step)
        path = path.at[:, PC_VMAX].set(v_prof)
        return new_pts, merged, path, il, isd, cost

    @jax.jit
    def lon_stage(occ_map, path, env_scalars, ppn, x0, prev_pt):
        """Projection of the previous trajectory point -> path distance
        map -> lon DP solve.  env_scalars: packed f32 [s_min,
        s_step_size, l_min, l_step_size] of the ENV grid."""
        ppn_d = unpack_lon_pp(ppn)
        arc = project_polyline(path[:, :2], prev_pt)["arc_len"]
        x0 = x0.at[LC_S].set(arc)

        s_step_lon = (ppn_d["s_max"] - ppn_d["s_min"]) / (S_LON - 1)
        dists = jnp.arange(S_LON, dtype=f32) * s_step_lon
        a = dists / ppn_d["path_step_size"]
        i0 = jnp.clip(jnp.floor(a), 0, P - 1).astype(jnp.int32)
        i1 = jnp.clip(jnp.ceil(a), 0, P - 1).astype(jnp.int32)
        al = jnp.clip(a - i0, 0.0, 1.0)[:, None]
        interp = path[i0] * (1.0 - al) + path[i1] * al
        path_sl = interp[:, jnp.asarray([PC_S, PC_L])]

        dist_path = dpe._dist_map_path(
            occ_map, path_sl, env_scalars[0], env_scalars[1],
            env_scalars[2], env_scalars[3])
        _nodes, traj = lon_solve(dist_path, path, ppn, x0)
        return traj, arc

    return lat_stage, lon_stage


class ChainRunner:
    """Shared driver-side front end over the fused chain: program cache
    keyed on the grid spec, the three async dispatches and the single
    batched pull.  Used by both the FAS-2025
    and lattice drivers (their replans differ only in the splice
    prefix, the projection point and the rampify step)."""

    def __init__(self, rampify_step_path=False):
        self.rampify_step_path = rampify_step_path
        self._lat_stage = None
        self._lon_stage = None
        self._spec = None

    def get(self, cpp_lat, cpp_lon, env_params):
        spec = dict(s_steps=cpp_lat.s_steps,
                    l_dst_steps=cpp_lat.l_dst_steps,
                    s_dst_steps=cpp_lat.s_dst_steps,
                    t_steps_env=env_params.t_steps,
                    s_steps_env=env_params.s_steps,
                    l_steps_env=env_params.l_steps,
                    t_steps=cpp_lon.t_steps,
                    s_steps_lon=cpp_lon.s_steps,
                    v_steps=cpp_lon.v_steps, a_steps=cpp_lon.a_steps,
                    path_steps=cpp_lon.path_steps,
                    rampify_step_path=self.rampify_step_path)
        if self._spec != spec:
            self._lat_stage, self._lon_stage = make_poly_chain(spec)
            self._spec = spec
        return self._lat_stage, self._lon_stage

    def replan(self, cppe, cpp_lat, cpp_lon, start_vec, old_pts, n_keep,
               x0, prev_pt):
        """Run the full fused replan against a DpEnvironment whose env
        grid build has already been dispatched (cppe.update()).
        Returns the pulled (new_pts, path, il, isd, cost, traj, arc)."""
        from tpl_tpu.planning.dyn_prog.poly_lat_kernel import pack_env_pp
        lat_stage, lon_stage = self.get(cpp_lat, cpp_lon, cppe.params)
        new_pts_d, _m, path_d, il_d, isd_d, cost_d = lat_stage(
            cppe.grid.occ_map, cppe.grid.ref_line,
            jnp.float32(cppe.ref_step), cpp_lat.packed(),
            pack_env_pp(cppe.params), cpp_lon.packed(),
            jnp.asarray(start_vec), jnp.asarray(old_pts),
            jnp.int32(n_keep))

        pe = cppe.params
        env_scalars = np.array([pe.s_min, pe.s_step_size, pe.l_min,
                                pe.l_step_size], np.float32)
        traj_d, arc_d = lon_stage(
            cppe.grid.occ_map, path_d, jnp.asarray(env_scalars),
            cpp_lon.packed(), jnp.asarray(x0, jnp.float32),
            jnp.asarray(prev_pt))

        # the ONE host sync of the replan: a single batched pull
        return jax.device_get((new_pts_d, path_d, il_d, isd_d, cost_d,
                               traj_d, arc_d))
