"""
Lat/lon DP planner kernel: value iteration over the (s, ds, l) state grid
across time slices with (dds, dl) action sampling, plus the greedy forward
rollout — as jitted XLA programs over dense grids.

JAX re-design of the reference's CUDA value iteration (reference:
library/src/dyn_prog/lat_lon_planner.cu): one thread per grid cell becomes
one vectorized evaluation over the whole (S, DS, L, A_dds, A_dl) tensor per
time slice; the CUDA texture value lookups (point for backward,
trilinear for forward, arr_tex_surf.cuh:136-167) become explicit
round-index gathers / manual trilinear interpolation.

State trajectory layout (columns): t, s, ds, dds, ddds, l, dl, ddl, dddl,
cost, constr, flags (matching LatLonState, lat_lon_planner.cuh:82-110).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.planning.dyn_prog.dp_common import (
    lex_argmin, recip, unit_grid)


# trajectory column indices
C_T, C_S, C_DS, C_DDS, C_DDDS, C_L, C_DL, C_DDL, C_DDDL, C_COST, \
    C_CONSTR, C_FLAGS = range(12)

CONSTR_OCCUPANCY = 1
CONSTR_VELOCITY = 2
CONSTR_ANGLE = 4


class LatLonParams:
    """(reference: lat_lon_planner.cuh:9-62)"""

    def __init__(self):
        self.s_min = 0.0
        self.s_max = 200.0
        self.ds_min = 0.0
        self.ds_max = 36.0
        self.l_min = -5.0
        self.l_max = 5.0

        self.dds_min = -2.0
        self.dds_max = 2.0
        self.dl_min = -2.0
        self.dl_max = 2.0

        self.t_steps = 10
        self.s_steps = 201
        self.ds_steps = 37
        self.l_steps = 21

        self.dt = 1.0
        self.dt_start = 1.0
        self.dt_smooth_traj = 0.1

        self.dds_start = 0.0
        self.w_dds_start = 10.0
        self.angle_start = 0.0
        self.w_angle_start = 10.0

        self.l_trg = 0.0

        self.w_progress = 1.0
        self.w_dds = 1.0
        self.w_ddds = 1.0
        self.w_l = 1.0
        self.w_dl = 1.0
        self.w_ddl = 1.0
        self.w_safety_dist = 10.0
        self.w_xing_slow = 1.0

        self.slope_abs_max = 0.8

        self.w_lat_dist = 0.0
        self.d_lat_comf = 2.0

        self.time_gap = 2.0
        self.gap_min = 2.0

        self.t_st_min = -1.0
        self.t_st_max = -1.0
        self.s_st = 0.0
        self.w_spatio_temporal = 10.0

        self.width_veh = 2.0
        self.length_veh = 6.0

    @property
    def s_step(self):
        return (self.s_max - self.s_min) / (self.s_steps - 1)

    @property
    def ds_step(self):
        return (self.ds_max - self.ds_min) / (self.ds_steps - 1)

    @property
    def l_step(self):
        return (self.l_max - self.l_min) / (self.l_steps - 1)

    def dynamic_dict(self):
        return {k: jnp.float32(getattr(self, k)) for k in PP_KEYS}

    def packed(self):
        """All dynamic params as ONE f32 vector: a single host->device
        transfer per call instead of one per scalar leaf (each jitted-arg
        leaf is its own transfer)."""
        return np.array([getattr(self, k) for k in PP_KEYS],
                        dtype=np.float32)


PP_KEYS = ("s_min", "s_max", "ds_min", "ds_max", "l_min", "l_max",
           "dds_min", "dds_max", "dl_min", "dl_max", "dt", "dt_start",
           "l_trg", "w_progress", "w_dds", "w_ddds", "w_l", "w_dl",
           "w_ddl", "w_safety_dist", "w_xing_slow", "slope_abs_max",
           "w_lat_dist", "d_lat_comf", "time_gap", "gap_min",
           "t_st_min", "t_st_max", "s_st", "w_spatio_temporal",
           "width_veh", "length_veh")


def unpack_pp(vec):
    """Expand a packed param vector back into the kernels' dict form
    (traced, inside jit)."""
    return {k: vec[i] for i, k in enumerate(PP_KEYS)}


def _f32_args(pp, *xs):
    """The device programs run in f32; inputs may arrive as f64 under
    x64, and ``pp`` as a dict or a packed vector."""
    if not isinstance(pp, dict):
        pp = unpack_pp(pp)

    def f32(v):
        v = jnp.asarray(v)
        return v.astype(jnp.float32) if jnp.issubdtype(
            v.dtype, jnp.floating) else v
    return ({k: f32(v) for k, v in pp.items()},) + tuple(f32(x) for x in xs)


def latlon_dynamics_np(state, dds, dl, dt):
    """Host twin of the clamped double-integrator lon / rate lat dynamics
    (lat_lon_planner.cu:10-21). state: (12,) array."""
    res = np.array(state, dtype=np.float64).copy()
    res[C_T] = state[C_T] + dt
    res[C_S] = max(state[C_S],
                   state[C_S] + state[C_DS] * dt + 0.5 * dds * dt * dt)
    res[C_DS] = max(0.0, state[C_DS] + dds * dt)
    res[C_DDS] = dds
    res[C_L] = state[C_L] + dl * dt
    res[C_DL] = dl
    res[C_DDL] = 0.0
    res[C_DDDS] = 0.0
    res[C_DDDL] = 0.0
    return res


def _ref_tex(ref_line, ref_step, s):
    """Nearest-index ref line channels (RefLineGpu::texLerp)."""
    n = ref_line.shape[0]
    i = jnp.clip(jnp.round(s / ref_step), 0, n - 1).astype(jnp.int32)
    return ref_line[i]


def _dist_lookup(dist_x, t_idx, is_, il_):
    """dist_map_lon channel-0 lookup at integer indices."""
    return dist_x[t_idx, is_, il_]


def _dl_samples_backward(pp, n2):
    """Center-out dl sample values (lat_lon_planner.cu:202-236)."""
    step = (pp["dl_max"] - pp["dl_min"]) * recip(2 * n2)
    ks = jnp.arange(1, n2 + 1, dtype=jnp.float32)
    return jnp.concatenate([jnp.zeros(1, jnp.float32), step * ks,
                            -step * ks])


def _d_fwd_sweep(D_at, n2):
    """Incremental lateral-sweep min over center-out samples.

    D_at: (..., 2*n2+1) distances at the swept lateral offsets in
    center-out order. Returns same-shape cumulative mins per side.
    """
    center = D_at[..., :1]
    left = jnp.minimum.accumulate(
        jnp.concatenate([center, D_at[..., 1:n2 + 1]], axis=-1), axis=-1)
    right = jnp.minimum.accumulate(
        jnp.concatenate([center, D_at[..., n2 + 1:]], axis=-1), axis=-1)
    return jnp.concatenate([center, left[..., 1:], right[..., 1:]], axis=-1)


def make_latlon_solver(spec):
    """Build the jitted DP solve for static grid sizes.

    spec: dict with t_steps, s_steps, ds_steps, l_steps (static).
    Returns solve(dist_map_lon, ref_line, ref_step, pp, x0) ->
    (nodes (T,S,DS,L,4), traj (T, 12)).
    """
    T = spec["t_steps"]
    S = spec["s_steps"]
    DS = spec["ds_steps"]
    L = spec["l_steps"]
    NB = 7     # backward action samples per dim
    NF = 21    # forward action samples per dim

    f32 = jnp.float32

    def grids(pp):
        s_step = (pp["s_max"] - pp["s_min"]) * recip(S - 1)
        ds_step = (pp["ds_max"] - pp["ds_min"]) * recip(DS - 1)
        l_step = (pp["l_max"] - pp["l_min"]) * recip(L - 1)
        ss = pp["s_min"] + jnp.arange(S, dtype=f32) * s_step
        dss = pp["ds_min"] + jnp.arange(DS, dtype=f32) * ds_step
        lls = pp["l_min"] + jnp.arange(L, dtype=f32) * l_step
        return ss, dss, lls, s_step, ds_step, l_step

    # ---- grid-wide getMid (lat_lon_planner.cu:80-117) ----

    def get_mid_grid(D_t, mean_dist, lls, l_step, pp):
        """D_t: (S, L) dist-ahead slice; mean_dist: (S, DS, L).
        Returns (x, y, z) each (S, DS, L)."""
        offs = jnp.arange(L)
        idxL = jnp.clip(offs[None, :] + offs[:, None], 0, L - 1)  # (L, Loff)
        idxR = jnp.clip(offs[:, None] - offs[None, :], 0, L - 1)

        DL_ = D_t[:, idxL]                      # (S, L, Loff)
        DR_ = D_t[:, idxR]

        condL = DL_[:, None, :, :] < mean_dist[..., None]   # (S,DS,L,Loff)
        condR = DR_[:, None, :, :] < mean_dist[..., None]

        foundL = jnp.any(condL, axis=-1)
        foundR = jnp.any(condR, axis=-1)
        iL = jnp.argmax(condL, axis=-1).astype(f32)
        iR = jnp.argmax(condR, axis=-1).astype(f32)

        l_g = lls[None, None, :]
        l_left = jnp.where(foundL, l_g + iL * l_step, 0.0)
        l_right = jnp.where(foundR, l_g - iR * l_step, 0.0)

        mid = l_right + (l_left - l_right) * 0.5
        y = jnp.minimum(l_right + pp["d_lat_comf"], mid)
        z = jnp.maximum(l_left - pp["d_lat_comf"], mid)
        x = jnp.where(pp["l_trg"] < l_right, y,
                      jnp.where(pp["l_trg"] > l_left, z, pp["l_trg"]))
        return x, y, z

    def eval_state_grid(t, ss, dss, lls, rl_tex, mid_x, mid_y, mid_z, pp):
        """(lat_lon_planner.cu:119-158). Returns cost, constr (S, DS, L)."""
        s_g = ss[:, None, None]
        ds_g = dss[None, :, None]
        l_g = lls[None, None, :]

        v_max_ref = rl_tex[:, 4][:, None, None]
        d_left_ref = (rl_tex[:, 5] - pp["width_veh"] * 0.5)[:, None, None]
        d_right_ref = -(rl_tex[:, 6] - pp["width_veh"] * 0.5)[:, None, None]

        cost = 1000.0 * jnp.maximum(0.0, l_g - d_left_ref)
        cost += 1000.0 * jnp.maximum(0.0, d_right_ref - l_g)

        cost += pp["w_l"] * (mid_x - l_g) ** 2
        cost += jnp.where(l_g < mid_y,
                          pp["w_lat_dist"] * (mid_y - l_g) ** 2, 0.0)
        cost += jnp.where(l_g > mid_z,
                          pp["w_lat_dist"] * (mid_z - l_g) ** 2, 0.0)

        cost += pp["w_progress"] * (1000.0 - s_g)

        vel_viol = ds_g > v_max_ref
        constr = jnp.where(vel_viol, ds_g - v_max_ref, 0.0)

        cost += jnp.where(t < pp["t_st_min"],
                          pp["w_spatio_temporal"]
                          * jnp.maximum(0.0, s_g - pp["s_st"]), 0.0)
        cost += jnp.where(t > pp["t_st_max"],
                          pp["w_spatio_temporal"]
                          * jnp.maximum(0.0, pp["s_st"] - s_g), 0.0)

        cost = jnp.broadcast_to(cost, (S, DS, L))
        constr = jnp.broadcast_to(constr, (S, DS, L))
        return cost, constr

    # ---- backward slice ----

    def backward_slice(nodes_next, i, dist_x, ref_line, ref_step, pp):
        ss, dss, lls, s_step, ds_step, l_step = grids(pp)
        dt = pp["dt"]
        t = pp["dt_start"] + (i - 1).astype(f32) * dt
        t_idx = jnp.clip(i, 0, T - 1)

        D_t = dist_x[t_idx]                      # (S, L)
        rl_tex = _ref_tex(ref_line, ref_step, ss)

        mean_dist = jnp.maximum(pp["length_veh"] * 0.5,
                                dss[None, :, None] * dt)
        mean_dist = jnp.broadcast_to(mean_dist, (S, DS, L))
        mid_x, mid_y, mid_z = get_mid_grid(D_t, mean_dist, lls, l_step, pp)

        state_cost, state_constr = eval_state_grid(
            t, ss, dss, lls, rl_tex, mid_x, mid_y, mid_z, pp)

        # action sampling
        n2 = NB // 2
        dds_s = pp["dds_min"] + (pp["dds_max"] - pp["dds_min"]) \
            * unit_grid(NB)                                      # (NB,)
        dl_s = _dl_samples_backward(pp, n2)                      # (NB,)

        # d_fwd per (S, L, dl): lateral sweep lookups, cumulative per side
        il2 = jnp.clip(jnp.round(
            (lls[:, None] + dl_s[None, :] * dt - pp["l_min"]) / l_step),
            0, L - 1).astype(jnp.int32)                          # (L, NB)
        D_at = D_t[:, il2]                                       # (S, L, NB)
        d_fwd = _d_fwd_sweep(D_at, n2)                           # (S, L, NB)
        d_fwd = d_fwd - pp["length_veh"] * 0.5
        # d_safety depends on ds: (S, DS, L, NBdl)
        d_safety = (d_fwd[:, None, :, :]
                    - pp["gap_min"]
                    - dss[None, :, None, None] * pp["time_gap"])

        # Next-state value lookup.  The lookup indices are STRUCTURED:
        # s_change doesn't depend on s and dl*dt doesn't depend on l, so
        # the s- and l-lookups are uniform edge-clamped SHIFTS per action
        # (round(s + x) == s + round(x) for integer s, incl. half-even
        # ties) and only ds maps to an arbitrary target row.  Expressing
        # the lookup as take-along-shifted-rows instead of one flat
        # 30M-element random gather keeps the moves contiguous.
        s_change = jnp.maximum(
            0.0, dss[:, None] * dt + 0.5 * dds_s[None, :] * dt * dt)  # (DS,NB)
        shift_s = jnp.round(s_change / s_step).astype(jnp.int32)  # (DS, NB)
        dsn = jnp.maximum(0.0, dss[:, None] + dds_s[None, :] * dt)
        ids_ = jnp.clip(jnp.round((dsn - pp["ds_min"]) / ds_step),
                        0, DS - 1).astype(jnp.int32)             # (DS, NBdds)
        shift_l = jnp.round(dl_s * dt / l_step).astype(jnp.int32)  # (NBdl,)

        P = DS * NB
        j_vec = ids_.reshape(P)
        k_vec = shift_s.reshape(P)
        # target-ds row per (ds, dds) pair, then clamped s shift
        C = jnp.moveaxis(jnp.take(nodes_next, j_vec, axis=1),
                         1, 0)                                   # (P, S, L, 4)
        idx_s = jnp.clip(jnp.arange(S, dtype=jnp.int32)[None, :]
                         + k_vec[:, None], 0, S - 1)             # (P, S)
        D = jnp.take_along_axis(C, idx_s[:, :, None, None], axis=1)
        # clamped l shift per dl action
        idx_l = jnp.clip(jnp.arange(L, dtype=jnp.int32)[None, :]
                         + shift_l[:, None], 0, L - 1)           # (NBdl, L)
        E = jnp.take(D, idx_l.reshape(-1), axis=2
                     ).reshape(P, S, NB, L, 4)
        nn = jnp.transpose(E.reshape(DS, NB, S, NB, L, 4),
                           (2, 0, 4, 1, 3, 5))                   # (S,DS,L,a,b,.)

        cost_next = nn[..., 0]
        constr_next = nn[..., 1]
        tn_dds = nn[..., 2]
        tn_dl = nn[..., 3]

        # action evaluation (lat_lon_planner.cu:160-192)
        l_change = dl_s * dt                                     # (NBdl,)
        slope = jnp.abs(l_change[None, None, :]
                        / s_change[:, :, None])                  # (DS,NBdds,NBdl)
        constr_a = jnp.where(slope > pp["slope_abs_max"],
                             jnp.abs(slope - pp["slope_abs_max"]) * 1000.0,
                             0.0)
        constr_a = jnp.nan_to_num(constr_a, nan=0.0)
        constr_a = jnp.broadcast_to(constr_a[None, :, None, :, :],
                                    (S, DS, L, NB, NB))

        sc_b = s_change[None, :, None, :, None]                  # -> dds axis 3
        occ_c = jnp.maximum(0.0, sc_b - d_fwd[:, None, :, None, :])
        constr_all = constr_a + occ_c + constr_next

        cost_a = pp["w_safety_dist"] * jnp.maximum(
            0.0, sc_b - d_safety[:, :, :, None, :])
        cost_a += pp["w_dds"] * (dds_s[None, None, None, :, None] * dt) ** 2
        cost_a += pp["w_ddds"] * (tn_dds
                                  - dds_s[None, None, None, :, None]) ** 2
        cost_a += pp["w_dl"] * (dl_s[None, None, None, None, :] * dt) ** 2
        cost_a += pp["w_ddl"] * (tn_dl
                                 - dl_s[None, None, None, None, :]) ** 2
        cost_all = cost_a + cost_next

        # lexicographic (constr, cost) argmin, scan order: dl outer, dds
        # inner (first minimum wins, matching the sequential CUDA scan)
        cost_o = jnp.swapaxes(cost_all, 3, 4).reshape(S, DS, L, NB * NB)
        constr_o = jnp.swapaxes(constr_all, 3, 4).reshape(S, DS, L, NB * NB)
        aidx, _, constr_o, cost_o = lex_argmin(constr_o, cost_o)  # (S,DS,L)

        dl_idx = aidx // NB
        dds_idx = aidx % NB
        dds_best = dds_s[dds_idx]
        dl_best = dl_s[dl_idx]

        tot_cost = jnp.take_along_axis(cost_o, aidx[..., None],
                                       axis=-1)[..., 0]
        tot_constr = jnp.take_along_axis(constr_o, aidx[..., None],
                                         axis=-1)[..., 0]

        node = jnp.stack([state_cost + tot_cost,
                          state_constr + tot_constr,
                          dds_best, dl_best], axis=-1)
        return node.astype(f32)

    def final_slice(dist_x, ref_line, ref_step, pp):
        """Slice T-1: state cost + finalState (lat_lon_planner.cu:66-78)."""
        ss, dss, lls, s_step, ds_step, l_step = grids(pp)
        dt = pp["dt"]
        t = pp["dt_start"] + f32(T - 2) * dt
        D_t = dist_x[T - 1]
        rl_tex = _ref_tex(ref_line, ref_step, ss)

        mean_dist = jnp.broadcast_to(
            jnp.maximum(pp["length_veh"] * 0.5, dss[None, :, None] * dt),
            (S, DS, L))
        mid_x, mid_y, mid_z = get_mid_grid(D_t, mean_dist, lls, l_step, pp)
        state_cost, state_constr = eval_state_grid(
            t, ss, dss, lls, rl_tex, mid_x, mid_y, mid_z, pp)

        on_xing = (jnp.round(rl_tex[:, 7]) == 1.0)[:, None, None]
        fin_cost = jnp.where(on_xing, pp["w_xing_slow"], 0.0)
        fin_cost = fin_cost + pp["w_l"] * (mid_x - lls[None, None, :]) ** 2

        node = jnp.stack([state_cost + fin_cost,
                          state_constr + jnp.zeros_like(state_constr),
                          jnp.zeros((S, DS, L), f32),
                          jnp.zeros((S, DS, L), f32)], axis=-1)
        return node.astype(f32)

    # ---- forward pass (single state per step, NFxNF interp actions) ----

    def trilerp(nodes, s, ds, l, pp, s_step, ds_step, l_step):
        """Manual trilinear interp of (S, DS, L, 4) at continuous coords."""
        x = jnp.clip((s - pp["s_min"]) / s_step, 0.0, S - 1.0)
        y = jnp.clip((ds - pp["ds_min"]) / ds_step, 0.0, DS - 1.0)
        z = jnp.clip((l - pp["l_min"]) / l_step, 0.0, L - 1.0)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        z0 = jnp.floor(z).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, S - 1)
        y1 = jnp.minimum(y0 + 1, DS - 1)
        z1 = jnp.minimum(z0 + 1, L - 1)
        ax = (x - x0)[..., None]
        ay = (y - y0)[..., None]
        az = (z - z0)[..., None]

        def g(ix, iy, iz):
            return nodes[ix, iy, iz]

        c000 = g(x0, y0, z0)
        c100 = g(x1, y0, z0)
        c010 = g(x0, y1, z0)
        c110 = g(x1, y1, z0)
        c001 = g(x0, y0, z1)
        c101 = g(x1, y0, z1)
        c011 = g(x0, y1, z1)
        c111 = g(x1, y1, z1)
        c00 = c000 * (1 - ax) + c100 * ax
        c10 = c010 * (1 - ax) + c110 * ax
        c01 = c001 * (1 - ax) + c101 * ax
        c11 = c011 * (1 - ax) + c111 * ax
        c0 = c00 * (1 - ay) + c10 * ay
        c1 = c01 * (1 - ay) + c11 * ay
        return c0 * (1 - az) + c1 * az

    def get_mid_single(D_t, s_idx, l, mean_dist, pp, l_step):
        offs = jnp.arange(L, dtype=f32)
        lL = l + offs * l_step
        lR = l - offs * l_step
        ilL = jnp.clip(jnp.round((lL - pp["l_min"]) / l_step),
                       0, L - 1).astype(jnp.int32)
        ilR = jnp.clip(jnp.round((lR - pp["l_min"]) / l_step),
                       0, L - 1).astype(jnp.int32)
        DL_ = D_t[s_idx, ilL]
        DR_ = D_t[s_idx, ilR]
        condL = DL_ < mean_dist
        condR = DR_ < mean_dist
        foundL = jnp.any(condL)
        foundR = jnp.any(condR)
        l_left = jnp.where(foundL, lL[jnp.argmax(condL)], 0.0)
        l_right = jnp.where(foundR, lR[jnp.argmax(condR)], 0.0)
        mid = l_right + (l_left - l_right) * 0.5
        y = jnp.minimum(l_right + pp["d_lat_comf"], mid)
        z = jnp.maximum(l_left - pp["d_lat_comf"], mid)
        x = jnp.where(pp["l_trg"] < l_right, y,
                      jnp.where(pp["l_trg"] > l_left, z, pp["l_trg"]))
        return x, y, z

    def eval_state_single(tp, D_t, rl_row, mid, pp):
        s, ds, l, t = tp[C_S], tp[C_DS], tp[C_L], tp[C_T]
        mid_x, mid_y, mid_z = mid
        v_max_ref = rl_row[4]
        d_left_ref = rl_row[5] - pp["width_veh"] * 0.5
        d_right_ref = -(rl_row[6] - pp["width_veh"] * 0.5)

        cost = 1000.0 * jnp.maximum(0.0, l - d_left_ref)
        cost += 1000.0 * jnp.maximum(0.0, d_right_ref - l)
        cost += pp["w_l"] * (mid_x - l) ** 2
        cost += jnp.where(l < mid_y, pp["w_lat_dist"] * (mid_y - l) ** 2, 0.0)
        cost += jnp.where(l > mid_z, pp["w_lat_dist"] * (mid_z - l) ** 2, 0.0)
        cost += pp["w_progress"] * (1000.0 - s)

        vel_viol = ds > v_max_ref
        constr = jnp.where(vel_viol, ds - v_max_ref, 0.0)
        flags = jnp.where(vel_viol, CONSTR_VELOCITY, 0).astype(jnp.int32)

        cost += jnp.where(t < pp["t_st_min"],
                          pp["w_spatio_temporal"]
                          * jnp.maximum(0.0, s - pp["s_st"]), 0.0)
        cost += jnp.where(t > pp["t_st_max"],
                          pp["w_spatio_temporal"]
                          * jnp.maximum(0.0, pp["s_st"] - s), 0.0)
        return cost, constr, flags

    def forward_step(tp, nodes_next, dist_x, ref_line, ref_step, pp, dt,
                     is_last):
        ss, dss, lls, s_step, ds_step, l_step = grids(pp)
        s, ds, l, t = tp[C_S], tp[C_DS], tp[C_L], tp[C_T]

        t_idx = jnp.where(t < pp["dt_start"], 0,
                          jnp.round((t - pp["dt_start"]) / pp["dt"]) + 1.0
                          ).astype(jnp.int32)
        t_idx = jnp.clip(t_idx, 0, T - 1)
        D_t = dist_x[t_idx]
        s_idx = jnp.clip(jnp.round((s - pp["s_min"]) / s_step),
                         0, S - 1).astype(jnp.int32)
        rl_row = _ref_tex(ref_line, ref_step, s)

        mean_dist = jnp.maximum(pp["length_veh"] * 0.5, ds * dt)
        mid = get_mid_single(D_t, s_idx, l, mean_dist, pp, l_step)
        st_cost, st_constr, st_flags = eval_state_single(
            tp, D_t, rl_row, mid, pp)

        # action search: NF x NF with trilinear value lookup
        n2 = NF // 2
        dds_s = pp["dds_min"] + (pp["dds_max"] - pp["dds_min"]) \
            * unit_grid(NF)
        step_dl = (pp["dl_max"] - pp["dl_min"]) * recip(NF - 1)
        ks = jnp.arange(1, n2 + 1, dtype=f32)
        dl_s = jnp.concatenate([jnp.zeros(1, f32), step_dl * ks,
                                -step_dl * ks])

        il2 = jnp.clip(jnp.round((l + dl_s * dt - pp["l_min"]) / l_step),
                       0, L - 1).astype(jnp.int32)
        D_at = D_t[s_idx, il2]                                    # (NF,)
        d_fwd = _d_fwd_sweep(D_at, n2) - pp["length_veh"] * 0.5   # (NF,)
        d_safety = d_fwd - pp["gap_min"] - ds * pp["time_gap"]

        s_change = jnp.maximum(0.0, ds * dt + 0.5 * dds_s * dt * dt)  # (NF,)
        sn = s + s_change
        dsn = jnp.maximum(0.0, ds + dds_s * dt)
        ln = l + dl_s * dt

        nn = trilerp(nodes_next,
                     jnp.broadcast_to(sn[:, None], (NF, NF)),
                     jnp.broadcast_to(dsn[:, None], (NF, NF)),
                     jnp.broadcast_to(ln[None, :], (NF, NF)),
                     pp, s_step, ds_step, l_step)                 # (NF,NF,4)
        cost_next = nn[..., 0]
        constr_next = nn[..., 1]
        tn_dds = nn[..., 2]
        tn_dl = nn[..., 3]

        l_change = dl_s * dt
        slope = jnp.abs(l_change[None, :] / s_change[:, None])
        angle_c = jnp.where(slope > pp["slope_abs_max"],
                            jnp.abs(slope - pp["slope_abs_max"]) * 1000.0,
                            0.0)
        angle_c = jnp.nan_to_num(angle_c, nan=0.0)
        occ_c = jnp.maximum(0.0, s_change[:, None] - d_fwd[None, :])
        constr_a = angle_c + occ_c
        constr_all = constr_a + constr_next

        cost_a = pp["w_safety_dist"] * jnp.maximum(
            0.0, s_change[:, None] - d_safety[None, :])
        cost_a += pp["w_dds"] * (dds_s[:, None] * dt) ** 2
        cost_a += pp["w_ddds"] * (tn_dds - dds_s[:, None]) ** 2
        cost_a += pp["w_dl"] * (dl_s[None, :] * dt) ** 2
        cost_a += pp["w_ddl"] * (tn_dl - dl_s[None, :]) ** 2
        cost_all = cost_a + cost_next

        cost_o = cost_all.T.reshape(-1)      # dl outer, dds inner
        constr_o = constr_all.T.reshape(-1)
        aidx, _, _, _ = lex_argmin(constr_o, cost_o)
        dl_idx = aidx // NF
        dds_idx = aidx % NF
        dds_best = dds_s[dds_idx]
        dl_best = dl_s[dl_idx]

        a_cost = cost_a.T.reshape(-1)[aidx]
        a_constr = constr_a.T.reshape(-1)[aidx]
        a_flags = (jnp.where(angle_c.T.reshape(-1)[aidx] > 0,
                             CONSTR_ANGLE, 0)
                   | jnp.where(occ_c.T.reshape(-1)[aidx] > 0,
                               CONSTR_OCCUPANCY, 0)).astype(jnp.int32)

        tp = tp.at[C_COST].set(st_cost + jnp.where(is_last, 0.0, a_cost))
        tp = tp.at[C_CONSTR].set(
            st_constr + jnp.where(is_last, 0.0, a_constr))
        tp = tp.at[C_FLAGS].set(
            (st_flags | jnp.where(is_last, 0, a_flags)).astype(f32))
        tp = tp.at[C_DDS].set(jnp.where(is_last, tp[C_DDS], dds_best))
        tp = tp.at[C_DL].set(jnp.where(is_last, tp[C_DL], dl_best))

        # next state (dynamics, lat_lon_planner.cu:10-21)
        tn = jnp.zeros_like(tp)
        tn = tn.at[C_T].set(tp[C_T] + dt)
        tn = tn.at[C_S].set(jnp.maximum(
            s, s + ds * dt + 0.5 * dds_best * dt * dt))
        tn = tn.at[C_DS].set(jnp.maximum(0.0, ds + dds_best * dt))
        tn = tn.at[C_DDS].set(dds_best)
        tn = tn.at[C_L].set(l + dl_best * dt)
        tn = tn.at[C_DL].set(dl_best)
        return tp, tn

    @jax.jit
    def solve(dist_map_lon, ref_line, ref_step, pp, x0):
        pp, dist_map_lon, ref_line, ref_step, x0 = _f32_args(
            pp, dist_map_lon, ref_line, ref_step, x0)
        dist_x = dist_map_lon[..., 0]

        # backward pass: slice T-1 (final), then T-2 .. 1
        nodes_final = final_slice(dist_x, ref_line, ref_step, pp)

        def bwd(carry, i):
            node = backward_slice(carry, i, dist_x, ref_line, ref_step, pp)
            return node, node

        idxs = jnp.arange(T - 2, 0, -1)
        with jax.named_scope("latlon_backward"):
            _, nodes_seq = jax.lax.scan(bwd, nodes_final, idxs)
        # nodes_seq[k] is slice T-2-k; assemble full (T, S, DS, L, 4)
        nodes_mid = nodes_seq[::-1]                   # slices 1 .. T-2
        nodes = jnp.concatenate([
            jnp.zeros((1, S, DS, L, 4), jnp.float32),
            nodes_mid,
            nodes_final[None]], axis=0).astype(jnp.float32)

        # forward pass
        def fwd(tp, i):
            dt_i = jnp.where(i == 0, pp["dt_start"], pp["dt"])
            nodes_next = nodes[jnp.minimum(i + 1, T - 1)]
            tp_out, tn = forward_step(tp, nodes_next, dist_x, ref_line,
                                      ref_step, pp, dt_i, i == T - 1)
            return tn, tp_out

        with jax.named_scope("latlon_forward"):
            _, traj = jax.lax.scan(fwd, x0.astype(jnp.float32),
                                   jnp.arange(T))
        return nodes, traj

    @jax.jit
    def reeval(dist_map_lon, ref_line, ref_step, pp, traj):
        """Re-evaluate a stored trajectory against a fresh environment,
        entirely on device (device twin of HostEval.reeval; reference:
        lat_lon_planner.cu:358-402 reevalTraj).  Keeps the per-tick replan
        check to one small dispatch + one (N, 12) pull instead of pulling
        the whole distance grid to the host."""
        pp, dist_map_lon, ref_line, ref_step, traj = _f32_args(
            pp, dist_map_lon, ref_line, ref_step, traj)
        dist_x = dist_map_lon[..., 0]

        _, _, _, s_step, ds_step, l_step = grids(pp)
        N = traj.shape[0]
        t = traj[:, C_T]
        s = traj[:, C_S]
        ds = traj[:, C_DS]
        l = traj[:, C_L]
        dl = traj[:, C_DL]
        dds = traj[:, C_DDS]

        last = jnp.arange(N) == N - 1
        dt = jnp.where(last, 0.0, jnp.roll(t, -1) - t)

        t_idx = jnp.where(t < pp["dt_start"], 0,
                          jnp.round((t - pp["dt_start"]) / pp["dt"]) + 1.0
                          ).astype(jnp.int32)
        t_idx = jnp.clip(t_idx, 0, T - 1)
        s_idx = jnp.clip(jnp.round((s - pp["s_min"]) / s_step),
                         0, S - 1).astype(jnp.int32)
        rl_rows = _ref_tex(ref_line, ref_step, s)                 # (N, 8)

        mean_dist = jnp.maximum(pp["length_veh"] * 0.5, ds * dt)

        def per_node(tp, D_t, s_i, rl_row, md):
            mid = get_mid_single(D_t, s_i, tp[C_L], md, pp, l_step)
            return eval_state_single(tp, D_t, rl_row, mid, pp)

        st_cost, st_constr, st_flags = jax.vmap(per_node)(
            traj, dist_x[t_idx], s_idx, rl_rows, mean_dist)

        # lateral sweep toward l + dt * dl (HostEval.reeval)
        l_dist = dl * dt
        steps = jnp.ceil(jnp.abs(l_dist) / l_step)
        n_sweep = jnp.maximum(steps, 1.0)
        step_size = jnp.where(steps > 0, l_dist / jnp.maximum(steps, 1.0),
                              0.0)
        ks = jnp.arange(L, dtype=f32)                             # (L,)
        l_k = l[:, None] + ks[None, :] * step_size[:, None]       # (N, L)
        il_k = jnp.clip(jnp.round((l_k - pp["l_min"]) / l_step),
                        0, L - 1).astype(jnp.int32)
        d_k = dist_x[t_idx[:, None], s_idx[:, None], il_k]        # (N, L)
        d_k = jnp.where(ks[None, :] < n_sweep[:, None], d_k, jnp.inf)
        d_fwd = jnp.min(d_k, axis=1) - pp["length_veh"] * 0.5
        d_safety = d_fwd - pp["gap_min"] - ds * pp["time_gap"]

        # pairwise terms vs the next node (zeroed on the last node)
        s_change = jnp.roll(s, -1) - s
        l_change = jnp.roll(l, -1) - l
        slope = jnp.abs(l_change / s_change)
        angle_viol = jnp.isfinite(slope) & (slope > pp["slope_abs_max"]) \
            & ~last
        constr = st_constr
        constr += jnp.where(angle_viol,
                            jnp.abs(slope - pp["slope_abs_max"]) * 1000.0,
                            0.0)
        occ_viol = (s_change > d_fwd) & ~last
        constr += jnp.where(occ_viol, s_change - d_fwd, 0.0)

        cost = st_cost
        cost += jnp.where(last, 0.0, pp["w_safety_dist"]
                          * jnp.maximum(0.0, s_change - d_safety))
        ddds = jnp.roll(dds, -1) - dds
        ddl = jnp.roll(dl, -1) - dl
        pair_cost = (pp["w_dds"] * (dds * dt) ** 2
                     + pp["w_ddds"] * ddds ** 2
                     + pp["w_dl"] * (dl * dt) ** 2
                     + pp["w_ddl"] * ddl ** 2)
        cost += jnp.where(last, 0.0, pair_cost)

        flags = (st_flags
                 | jnp.where(angle_viol, CONSTR_ANGLE, 0)
                 | jnp.where(occ_viol, CONSTR_OCCUPANCY, 0))

        traj = traj.at[:, C_COST].set(cost)
        traj = traj.at[:, C_CONSTR].set(constr)
        traj = traj.at[:, C_FLAGS].set(flags.astype(f32))
        return traj

    @jax.jit
    def backward_step(nodes_next, i, dist_map_lon, ref_line, ref_step, pp):
        """Backward slice ``i`` from the given next-slice nodes, the unit
        the solve scans over.  Exposed so two backends can be compared
        slice by slice from the same input: over a whole solve, a tie
        broken differently in one slice changes the action the slice
        before it penalises against (w_ddds, w_ddl)."""
        pp, dist_map_lon, ref_line, ref_step = _f32_args(
            pp, dist_map_lon, ref_line, ref_step)
        return backward_slice(nodes_next, i, dist_map_lon[..., 0], ref_line,
                              ref_step, pp)

    solve.backward_step = backward_step
    return solve, reeval


def make_latlon_replan(spec):
    """Env-build + DP solve chained with NO host sync in between.

    Both stages are separate jitted programs; the env grids stay
    device-resident and feed the solve directly, so a replan pass costs
    two asynchronous dispatches plus exactly one small trajectory pull.

    Returns (replan, solve, reeval); replan(*env_inputs, ppv, x0) ->
    (occ_map, dist_map_lon, traj) with env_inputs from
    DpEnvironment.device_inputs().
    """
    from tpl_tpu.planning.dyn_prog import dp_environment as dpe

    solve, reeval = make_latlon_solver(spec)
    T, S, L = spec["t_steps"], spec["s_steps"], spec["l_steps"]

    def replan(ref_line, ref_step, quads, tbit, stat, valid, dilation,
               s_min, s_step, l_min, l_step, ppv, x0):
        occ, dist_lon = dpe._build_grids(
            ref_line, ref_step, quads, tbit, stat, valid, dilation,
            s_min, s_step, l_min, l_step, T, S, L)
        _, traj = solve(dist_lon, ref_line, ref_step, ppv, x0)
        return occ, dist_lon, traj

    return replan, solve, reeval


# ---------------------------------------------------------------------
# Host-side evaluator for trajectory re-evaluation against a fresh
# environment (reference: lat_lon_planner.cu:358-402 reevalTraj) and the
# smoothing / cartesian post-processing (lat_lon_planner.cu:645-825).
# ---------------------------------------------------------------------

class HostEval:
    """Numpy twin of the device evaluator over pulled grids."""

    def __init__(self, dist_map_lon, ref_line, ref_step, params):
        self.dist_x = np.asarray(dist_map_lon)[..., 0]
        self.ref_line = np.asarray(ref_line)
        self.ref_step = ref_step
        self.p = params

    def t_index(self, t):
        p = self.p
        if t < p.dt_start:
            return 0
        return int(min(self.dist_x.shape[0] - 1,
                       round((t - p.dt_start) / p.dt) + 1))

    def ref_tex(self, s):
        i = int(np.clip(round(s / self.ref_step), 0, len(self.ref_line) - 1))
        return self.ref_line[i]

    def dist(self, t, s, l):
        p = self.p
        S = self.dist_x.shape[1]
        L = self.dist_x.shape[2]
        si = int(np.clip(round((s - p.s_min) / p.s_step), 0, S - 1))
        li = int(np.clip(round((l - p.l_min) / p.l_step), 0, L - 1))
        return self.dist_x[self.t_index(t), si, li]

    def get_mid(self, t, s, l, ds, dt):
        p = self.p
        L = self.dist_x.shape[2]
        mean_dist = max(p.length_veh * 0.5, ds * dt)
        l_left = 0.0
        l_right = 0.0
        for i in range(L):
            if self.dist(t, s, l + i * p.l_step) < mean_dist:
                l_left = l + i * p.l_step
                break
        for i in range(L):
            if self.dist(t, s, l - i * p.l_step) < mean_dist:
                l_right = l - i * p.l_step
                break
        mid = l_right + (l_left - l_right) * 0.5
        y = min(l_right + p.d_lat_comf, mid)
        z = max(l_left - p.d_lat_comf, mid)
        if p.l_trg < l_right:
            x = y
        elif p.l_trg > l_left:
            x = z
        else:
            x = p.l_trg
        return x, y, z, l_left, l_right

    def eval_state(self, tp, dt):
        p = self.p
        t, s, ds, l = tp[C_T], tp[C_S], tp[C_DS], tp[C_L]
        rl = self.ref_tex(s)
        cost = 0.0
        constr = 0.0
        flags = 0

        d_left_ref = rl[5] - p.width_veh * 0.5
        d_right_ref = -(rl[6] - p.width_veh * 0.5)
        cost += 1000.0 * max(0.0, l - d_left_ref)
        cost += 1000.0 * max(0.0, d_right_ref - l)

        mid_x, mid_y, mid_z, _, _ = self.get_mid(t, s, l, ds, dt)
        cost += p.w_l * (mid_x - l) ** 2
        if l < mid_y:
            cost += p.w_lat_dist * (mid_y - l) ** 2
        if l > mid_z:
            cost += p.w_lat_dist * (mid_z - l) ** 2

        cost += p.w_progress * (1000.0 - s)

        if ds > rl[4]:
            constr += ds - rl[4]
            flags |= CONSTR_VELOCITY

        if t < p.t_st_min:
            cost += p.w_spatio_temporal * max(0.0, s - p.s_st)
        if t > p.t_st_max:
            cost += p.w_spatio_temporal * max(0.0, p.s_st - s)
        return cost, constr, flags

    def reeval(self, traj):
        """traj: (N, 12) numpy; returns re-evaluated copy.
        (lat_lon_planner.cu:358-402)"""
        p = self.p
        traj = np.array(traj, dtype=np.float64)
        n = len(traj)
        for i in range(n):
            tp = traj[i]
            dt = 0.0 if i == n - 1 else traj[i + 1][C_T] - tp[C_T]
            cost, constr, flags = self.eval_state(tp, dt)

            l_next = tp[C_L] + dt * tp[C_DL]
            l_dist = l_next - tp[C_L]
            steps = int(np.ceil(abs(l_dist) / p.l_step))
            d_fwd = self.dist(tp[C_T], tp[C_S], tp[C_L])
            if steps > 0:
                step_size = l_dist / steps
                for k in range(steps):
                    d_fwd = min(d_fwd, self.dist(
                        tp[C_T], tp[C_S], tp[C_L] + k * step_size))
            d_fwd -= p.length_veh * 0.5
            d_safety = d_fwd - p.gap_min - tp[C_DS] * p.time_gap

            if i < n - 1:
                tn = traj[i + 1]
                s_change = tn[C_S] - tp[C_S]
                l_change = tn[C_L] - tp[C_L]
                with np.errstate(divide="ignore", invalid="ignore"):
                    slope = abs(l_change / s_change)
                if np.isfinite(slope) and slope > p.slope_abs_max:
                    constr += abs(slope - p.slope_abs_max) * 1000.0
                    flags |= CONSTR_ANGLE
                if s_change > d_fwd:
                    constr += s_change - d_fwd
                    flags |= CONSTR_OCCUPANCY
                cost += p.w_safety_dist * max(0.0, s_change - d_safety)
                ddds = tn[C_DDS] - tp[C_DDS]
                ddl = tn[C_DL] - tp[C_DL]
                cost += p.w_dds * (tp[C_DDS] * dt) ** 2
                cost += p.w_ddds * ddds ** 2
                cost += p.w_dl * (tp[C_DL] * dt) ** 2
                cost += p.w_ddl * ddl ** 2

            traj[i][C_COST] = cost
            traj[i][C_CONSTR] = constr
            traj[i][C_FLAGS] = float(flags)
        return traj
