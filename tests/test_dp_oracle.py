"""Exhaustive small-grid optimality oracles for the DP value iterations.

The two subtlest pieces of the lat/lon and lon DP kernels are (a) the
exact two-stage lexicographic (constr, cost) argmin (reference:
library/src/dyn_prog/lat_lon_planner.cu:35-42 two-key compares) and (b)
the structured shifted-row next-value lookup
(lat_lon_kernel.py:306-340), which rewrites the reference's per-thread
round-index gather as uniform edge-clamped row shifts.  These oracles
re-implement the per-cell CUDA semantics naively in numpy — explicit
per-state loops, per-action round-index lookups, sequential first-min
scans — on a tiny grid, and require the whole-tensor kernels to agree:
near-exactly on the value/constraint channels and EXACTLY on the argmin
action channels and the forward trajectory.

All oracle arithmetic is float32 to share the kernels' tie landscape.
"""

import numpy as np
import jax.numpy as jnp

from tpl_tpu.planning.dyn_prog import lat_lon_kernel as llk
from tpl_tpu.planning.dyn_prog import lon_kernel as lk


F = np.float32


# ---------------------------------------------------------------------
# lat/lon DP oracle (naive per-cell twin of backward_slice/final_slice)
# ---------------------------------------------------------------------

def _ll_pp(spec):
    pp = llk.LatLonParams()
    pp.t_steps = spec["t_steps"]
    pp.s_steps = spec["s_steps"]
    pp.ds_steps = spec["ds_steps"]
    pp.l_steps = spec["l_steps"]
    pp.s_max = 40.0
    pp.ds_max = 12.0
    pp.l_min = -3.0
    pp.l_max = 3.0
    pp.w_lat_dist = 0.5
    return pp


def _ll_grids(pp):
    S, DS, L = pp.s_steps, pp.ds_steps, pp.l_steps
    ss = F(pp.s_min) + np.arange(S, dtype=F) * F(pp.s_step)
    dss = F(pp.ds_min) + np.arange(DS, dtype=F) * F(pp.ds_step)
    lls = F(pp.l_min) + np.arange(L, dtype=F) * F(pp.l_step)
    return ss, dss, lls


def _ll_ref_tex(ref_line, ref_step, s):
    i = int(np.clip(round(float(s) / ref_step), 0, len(ref_line) - 1))
    return ref_line[i]


def _ll_get_mid(D_t, s_idx, l, mean_dist, pp):
    """Per-state getMid (lat_lon_planner.cu:80-117): march outward in
    l_step increments until the distance-ahead drops below mean_dist."""
    L = pp.l_steps
    l_left = F(0.0)
    l_right = F(0.0)
    found_l = found_r = False
    for i in range(L):
        li = int(np.clip(round((l + i * F(pp.l_step) - F(pp.l_min))
                               / F(pp.l_step)), 0, L - 1))
        if D_t[s_idx, li] < mean_dist:
            l_left = F(l + i * F(pp.l_step))
            found_l = True
            break
    for i in range(L):
        li = int(np.clip(round((l - i * F(pp.l_step) - F(pp.l_min))
                               / F(pp.l_step)), 0, L - 1))
        if D_t[s_idx, li] < mean_dist:
            l_right = F(l - i * F(pp.l_step))
            found_r = True
            break
    if not found_l:
        l_left = F(0.0)
    if not found_r:
        l_right = F(0.0)
    mid = F(l_right + (l_left - l_right) * F(0.5))
    y = min(F(l_right + F(pp.d_lat_comf)), mid)
    z = max(F(l_left - F(pp.d_lat_comf)), mid)
    if pp.l_trg < l_right:
        x = y
    elif pp.l_trg > l_left:
        x = z
    else:
        x = F(pp.l_trg)
    return x, y, z


def _ll_eval_state(t, s, ds, l, rl_row, mid, pp):
    mid_x, mid_y, mid_z = mid
    v_max_ref = rl_row[4]
    d_left_ref = F(rl_row[5] - F(pp.width_veh) * F(0.5))
    d_right_ref = F(-(rl_row[6] - F(pp.width_veh) * F(0.5)))

    cost = F(1000.0) * max(F(0.0), F(l - d_left_ref))
    cost += F(1000.0) * max(F(0.0), F(d_right_ref - l))
    cost += F(pp.w_l) * F(mid_x - l) ** 2
    if l < mid_y:
        cost += F(pp.w_lat_dist) * F(mid_y - l) ** 2
    if l > mid_z:
        cost += F(pp.w_lat_dist) * F(mid_z - l) ** 2
    cost += F(pp.w_progress) * F(F(1000.0) - s)

    constr = F(max(0.0, ds - v_max_ref))

    if t < pp.t_st_min:
        cost += F(pp.w_spatio_temporal) * max(F(0.0), F(s - F(pp.s_st)))
    if t > pp.t_st_max:
        cost += F(pp.w_spatio_temporal) * max(F(0.0), F(F(pp.s_st) - s))
    return F(cost), F(constr)


def _ll_dl_samples(pp, n):
    n2 = n // 2
    step = F((pp.dl_max - pp.dl_min) / (2 * n2))
    return np.concatenate([[F(0.0)], step * np.arange(1, n2 + 1, dtype=F),
                           -step * np.arange(1, n2 + 1, dtype=F)])


def ll_oracle_backward(dist_x, ref_line, ref_step, pp):
    """Naive per-cell backward value iteration; returns nodes
    (T, S, DS, L, 4) with slice 0 zeroed like the kernel."""
    T, S, DS, L = pp.t_steps, pp.s_steps, pp.ds_steps, pp.l_steps
    NB = 7
    n2 = NB // 2
    ss, dss, lls = _ll_grids(pp)
    dt = F(pp.dt)

    dds_s = F(pp.dds_min) + F(pp.dds_max - pp.dds_min) \
        * np.arange(NB, dtype=F) / F(NB - 1)
    dl_s = _ll_dl_samples(pp, NB)

    nodes = np.zeros((T, S, DS, L, 4), F)

    # final slice
    t = F(pp.dt_start) + F(T - 2) * dt
    D_t = dist_x[T - 1]
    for i_s, s in enumerate(ss):
        rl_row = _ll_ref_tex(ref_line, ref_step, s)
        on_xing = round(float(rl_row[7])) == 1.0
        for i_ds, ds in enumerate(dss):
            mean_dist = F(max(pp.length_veh * 0.5, ds * dt))
            for i_l, l in enumerate(lls):
                mid = _ll_get_mid(D_t, i_s, l, mean_dist, pp)
                c, v = _ll_eval_state(t, s, ds, l, rl_row, mid, pp)
                fin = F(pp.w_xing_slow) if on_xing else F(0.0)
                fin += F(pp.w_l) * F(mid[0] - l) ** 2
                nodes[T - 1, i_s, i_ds, i_l] = [c + fin, v, 0.0, 0.0]

    # slices T-2 .. 1
    for i_t in range(T - 2, 0, -1):
        t = F(pp.dt_start) + F(i_t - 1) * dt
        t_idx = min(i_t, T - 1)
        D_t = dist_x[t_idx]
        nxt = nodes[i_t + 1]
        for i_s, s in enumerate(ss):
            rl_row = _ll_ref_tex(ref_line, ref_step, s)
            for i_ds, ds in enumerate(dss):
                mean_dist = F(max(pp.length_veh * 0.5, ds * dt))
                for i_l, l in enumerate(lls):
                    mid = _ll_get_mid(D_t, i_s, l, mean_dist, pp)
                    st_c, st_v = _ll_eval_state(t, s, ds, l, rl_row,
                                                mid, pp)

                    # evaluate all actions, dl outer / dds inner, with
                    # the per-thread round-index next-value lookup and
                    # the incremental center-out lateral sweep
                    n_act = NB * NB
                    a_constr = np.empty(n_act, F)
                    a_cost = np.empty(n_act, F)
                    d_fwd_side = {0: D_t[i_s, i_l]}
                    for k_dl, dl in enumerate(dl_s):
                        # cumulative sweep min along this side
                        il2 = int(np.clip(round(
                            (l + dl * dt - F(pp.l_min)) / F(pp.l_step)),
                            0, L - 1))
                        if k_dl == 0:
                            sweep = D_t[i_s, i_l]
                        else:
                            prev_key = 0 if k_dl in (1, n2 + 1) \
                                else k_dl - 1
                            sweep = min(d_fwd_side[prev_key],
                                        D_t[i_s, il2])
                        d_fwd_side[k_dl] = sweep
                        d_fwd = F(sweep - F(pp.length_veh) * F(0.5))
                        d_safety = F(d_fwd - F(pp.gap_min)
                                     - ds * F(pp.time_gap))
                        for k_dds, dds in enumerate(dds_s):
                            s_change = F(max(
                                0.0, ds * dt + F(0.5) * dds * dt * dt))
                            sn = F(s + s_change)
                            dsn = F(max(0.0, ds + dds * dt))
                            ln = F(l + dl * dt)
                            i_sn = int(np.clip(round(
                                (sn - F(pp.s_min)) / F(pp.s_step)),
                                0, S - 1))
                            i_dsn = int(np.clip(round(
                                (dsn - F(pp.ds_min)) / F(pp.ds_step)),
                                0, DS - 1))
                            i_ln = int(np.clip(round(
                                (ln - F(pp.l_min)) / F(pp.l_step)),
                                0, L - 1))
                            nn = nxt[i_sn, i_dsn, i_ln]

                            l_change = F(dl * dt)
                            with np.errstate(divide="ignore",
                                             invalid="ignore"):
                                slope = abs(l_change / s_change) \
                                    if s_change != 0.0 else np.inf \
                                    if l_change != 0.0 else np.nan
                            constr = F(0.0)
                            if np.isfinite(slope) \
                                    and slope > pp.slope_abs_max:
                                constr += F(abs(slope - F(pp.slope_abs_max))
                                            * F(1000.0))
                            elif np.isinf(slope):
                                constr += F(abs(np.float32(np.inf)))
                            constr += max(F(0.0), F(s_change - d_fwd))
                            constr += nn[1]

                            cost = F(pp.w_safety_dist) * max(
                                F(0.0), F(s_change - d_safety))
                            cost += F(pp.w_dds) * F(dds * dt) ** 2
                            cost += F(pp.w_ddds) * F(nn[2] - dds) ** 2
                            cost += F(pp.w_dl) * F(dl * dt) ** 2
                            cost += F(pp.w_ddl) * F(nn[3] - dl) ** 2
                            cost += nn[0]

                            a = k_dl * NB + k_dds
                            a_constr[a] = constr
                            a_cost[a] = cost

                    cmin = a_constr.min()
                    eligible = a_constr == cmin
                    costs = np.where(eligible, a_cost, np.inf)
                    aidx = int(np.argmin(costs))  # first min wins
                    nodes[i_t, i_s, i_ds, i_l] = [
                        st_c + a_cost[aidx], st_v + a_constr[aidx],
                        dds_s[aidx % NB], dl_s[aidx // NB]]
    return nodes


def _ll_scene(spec):
    pp = _ll_pp(spec)
    T, S, L = pp.t_steps, pp.s_steps, pp.l_steps
    rng = np.random.default_rng(7)

    n_ref = 17
    ref_step = 2.5
    ref_line = np.zeros((n_ref, 8), F)
    ref_line[:, 4] = 10.0                      # v_max
    ref_line[:, 5] = 3.0                       # d_left
    ref_line[:, 6] = 3.0                       # d_right
    ref_line[4, 7] = 1.0                       # one conflict cell

    # distance-ahead field: mostly free with a blocking band, plus noise
    # so value/cost ties between distinct actions are unlikely
    dist_x = np.full((T, S, L), 10000.0, F)
    dist_x += rng.uniform(0.0, 1.0, dist_x.shape).astype(F)
    for it in range(T):
        s_block = 4 + it  # moving obstacle
        if s_block < S:
            dist_x[it, : s_block, 2:4] = np.maximum(
                0.1, (s_block - np.arange(s_block, dtype=F))[:, None]
                * F(pp.s_step))
            dist_x[it, s_block, 2:4] = 0.0
    return pp, ref_line, F(ref_step), dist_x


def test_latlon_backward_matches_exhaustive_oracle():
    spec = dict(t_steps=4, s_steps=8, ds_steps=5, l_steps=5)
    pp, ref_line, ref_step, dist_x = _ll_scene(spec)
    T = pp.t_steps

    solve, _ = llk.make_latlon_solver(spec)
    dist_map = np.stack([dist_x, dist_x], axis=-1)
    nodes, traj = solve(jnp.asarray(dist_map), jnp.asarray(ref_line),
                        jnp.asarray(ref_step), pp.dynamic_dict(),
                        jnp.zeros(12, jnp.float32))
    nodes = np.asarray(nodes)

    oracle = ll_oracle_backward(dist_x, ref_line, float(ref_step), pp)

    # value/constraint channels: near-exact (f32 reassociation only)
    np.testing.assert_allclose(nodes[1:, ..., 0], oracle[1:, ..., 0],
                               rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(nodes[1:, ..., 1], oracle[1:, ..., 1],
                               rtol=2e-5, atol=2e-3)
    # argmin action channels: EXACT choice — this pins both the
    # lexicographic two-stage compare and the shifted-row lookup.
    # Values are mapped to their nearest sample index before comparing:
    # XLA's reciprocal-multiply rewrite perturbs the f32 sample values
    # themselves by ~2^-24, which is noise, while a wrong CHOICE is off
    # by a full sample step (0.67)
    NB = 7
    dds_s = F(pp.dds_min) + F(pp.dds_max - pp.dds_min) \
        * np.arange(NB, dtype=F) / F(NB - 1)
    dl_s = _ll_dl_samples(pp, NB)
    to_idx = lambda vals, samples: np.argmin(
        np.abs(vals[..., None] - samples), axis=-1)
    np.testing.assert_array_equal(
        to_idx(nodes[1:T - 1, ..., 2], dds_s),
        to_idx(oracle[1:T - 1, ..., 2], dds_s))
    np.testing.assert_array_equal(
        to_idx(nodes[1:T - 1, ..., 3], dl_s),
        to_idx(oracle[1:T - 1, ..., 3], dl_s))


def _ll_trilerp(nodes, s, ds, l, pp):
    S, DS, L = nodes.shape[0], nodes.shape[1], nodes.shape[2]
    x = np.clip((s - F(pp.s_min)) / F(pp.s_step), 0.0, S - 1.0)
    y = np.clip((ds - F(pp.ds_min)) / F(pp.ds_step), 0.0, DS - 1.0)
    z = np.clip((l - F(pp.l_min)) / F(pp.l_step), 0.0, L - 1.0)
    x0, y0, z0 = int(np.floor(x)), int(np.floor(y)), int(np.floor(z))
    x1, y1, z1 = min(x0 + 1, S - 1), min(y0 + 1, DS - 1), \
        min(z0 + 1, L - 1)
    ax, ay, az = F(x - x0), F(y - y0), F(z - z0)
    c00 = nodes[x0, y0, z0] * (1 - ax) + nodes[x1, y0, z0] * ax
    c10 = nodes[x0, y1, z0] * (1 - ax) + nodes[x1, y1, z0] * ax
    c01 = nodes[x0, y0, z1] * (1 - ax) + nodes[x1, y0, z1] * ax
    c11 = nodes[x0, y1, z1] * (1 - ax) + nodes[x1, y1, z1] * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    return c0 * (1 - az) + c1 * az


def ll_oracle_forward(nodes, dist_x, ref_line, ref_step, pp, x0):
    """Naive greedy forward rollout (per-step NFxNF trilinear action
    search with the sequential first-min lexicographic scan)."""
    T, L = pp.t_steps, pp.l_steps
    NF = 21
    n2 = NF // 2
    traj = np.zeros((T, 12), F)
    tp = np.asarray(x0, F).copy()

    dds_sam = F(pp.dds_min) + F(pp.dds_max - pp.dds_min) \
        * np.arange(NF, dtype=F) / F(NF - 1)
    step_dl = F((pp.dl_max - pp.dl_min) / (NF - 1))
    dl_sam = np.concatenate([[F(0.0)],
                             step_dl * np.arange(1, n2 + 1, dtype=F),
                             -step_dl * np.arange(1, n2 + 1, dtype=F)])

    for i in range(T):
        dt = F(pp.dt_start) if i == 0 else F(pp.dt)
        s, ds, l, t = tp[llk.C_S], tp[llk.C_DS], tp[llk.C_L], tp[llk.C_T]
        t_idx = 0 if t < pp.dt_start else int(min(
            T - 1, round((t - F(pp.dt_start)) / F(pp.dt)) + 1))
        D_t = dist_x[t_idx]
        s_idx = int(np.clip(round((s - F(pp.s_min)) / F(pp.s_step)),
                            0, pp.s_steps - 1))
        rl_row = _ll_ref_tex(ref_line, ref_step, s)
        mean_dist = F(max(pp.length_veh * 0.5, ds * dt))
        mid = _ll_get_mid(D_t, s_idx, l, mean_dist, pp)
        st_cost, st_constr = _ll_eval_state(t, s, ds, l, rl_row, mid, pp)

        nxt = nodes[min(i + 1, T - 1)]
        n_act = NF * NF
        a_cost = np.empty(n_act, F)
        a_constr = np.empty(n_act, F)
        a_only_cost = np.empty(n_act, F)
        a_only_constr = np.empty(n_act, F)
        sweep_prev = {0: D_t[s_idx, int(np.clip(round(
            (l - F(pp.l_min)) / F(pp.l_step)), 0, L - 1))]}
        for k_dl, dl in enumerate(dl_sam):
            il2 = int(np.clip(round(
                (l + dl * dt - F(pp.l_min)) / F(pp.l_step)), 0, L - 1))
            if k_dl == 0:
                sweep = sweep_prev[0]
            else:
                prev_key = 0 if k_dl in (1, n2 + 1) else k_dl - 1
                sweep = min(sweep_prev[prev_key], D_t[s_idx, il2])
            sweep_prev[k_dl] = sweep
            d_fwd = F(sweep - F(pp.length_veh) * F(0.5))
            d_safety = F(d_fwd - F(pp.gap_min) - ds * F(pp.time_gap))
            for k_dds, dds in enumerate(dds_sam):
                s_change = F(max(0.0, ds * dt + F(0.5) * dds * dt * dt))
                sn, dsn, ln = F(s + s_change), \
                    F(max(0.0, ds + dds * dt)), F(l + dl * dt)
                nn = _ll_trilerp(nxt, sn, dsn, ln, pp)
                l_change = F(dl * dt)
                with np.errstate(divide="ignore", invalid="ignore"):
                    slope = abs(l_change / s_change) \
                        if s_change != 0.0 else (
                            np.inf if l_change != 0.0 else np.nan)
                angle_c = F(0.0)
                if np.isfinite(slope) and slope > pp.slope_abs_max:
                    angle_c = F(abs(slope - F(pp.slope_abs_max))
                                * F(1000.0))
                elif np.isinf(slope):
                    angle_c = np.float32(np.inf)
                occ_c = max(F(0.0), F(s_change - d_fwd))
                cost_a = F(pp.w_safety_dist) * max(
                    F(0.0), F(s_change - d_safety))
                cost_a += F(pp.w_dds) * F(dds * dt) ** 2
                cost_a += F(pp.w_ddds) * F(nn[2] - dds) ** 2
                cost_a += F(pp.w_dl) * F(dl * dt) ** 2
                cost_a += F(pp.w_ddl) * F(nn[3] - dl) ** 2

                a = k_dl * NF + k_dds
                a_only_cost[a] = cost_a
                a_only_constr[a] = F(angle_c + occ_c)
                a_cost[a] = F(cost_a + nn[0])
                a_constr[a] = F(angle_c + occ_c + nn[1])

        cmin = a_constr.min()
        costs = np.where(a_constr == cmin, a_cost, np.inf)
        aidx = int(np.argmin(costs))
        dds_best = dds_sam[aidx % NF]
        dl_best = dl_sam[aidx // NF]

        is_last = i == T - 1
        out = tp.copy()
        out[llk.C_COST] = st_cost + (0.0 if is_last
                                     else a_only_cost[aidx])
        out[llk.C_CONSTR] = st_constr + (0.0 if is_last
                                         else a_only_constr[aidx])
        if not is_last:
            out[llk.C_DDS] = dds_best
            out[llk.C_DL] = dl_best
        traj[i] = out

        tn = np.zeros(12, F)
        tn[llk.C_T] = tp[llk.C_T] + dt
        tn[llk.C_S] = max(s, F(s + ds * dt + F(0.5) * dds_best
                               * dt * dt))
        tn[llk.C_DS] = max(F(0.0), F(ds + dds_best * dt))
        tn[llk.C_DDS] = dds_best
        tn[llk.C_L] = F(l + dl_best * dt)
        tn[llk.C_DL] = dl_best
        tp = tn
    return traj


def test_latlon_forward_matches_exhaustive_oracle():
    """The greedy forward rollout (NFxNF trilinear action search per
    step) picks the same argmin trajectory as a naive per-action
    enumeration over the kernel's own value tables."""
    spec = dict(t_steps=4, s_steps=8, ds_steps=5, l_steps=5)
    pp, ref_line, ref_step, dist_x = _ll_scene(spec)
    T = pp.t_steps

    solve, _ = llk.make_latlon_solver(spec)
    dist_map = np.stack([dist_x, dist_x], axis=-1)
    x0 = np.zeros(12, np.float32)
    x0[llk.C_DS] = 4.0
    x0[llk.C_L] = 0.6
    nodes, traj = solve(jnp.asarray(dist_map), jnp.asarray(ref_line),
                        jnp.asarray(ref_step), pp.dynamic_dict(),
                        jnp.asarray(x0))
    nodes = np.asarray(nodes)
    traj = np.asarray(traj)

    otraj = ll_oracle_forward(nodes, dist_x, ref_line, float(ref_step),
                              pp, x0)

    # states must agree to f32 noise; the chosen actions drive the
    # rollout, so matching states across all T steps pins the argmin
    # sequence
    np.testing.assert_allclose(traj[:, llk.C_S], otraj[:, llk.C_S],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(traj[:, llk.C_DS], otraj[:, llk.C_DS],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(traj[:, llk.C_L], otraj[:, llk.C_L],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(traj[:, llk.C_COST], otraj[:, llk.C_COST],
                               rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(traj[:, llk.C_CONSTR],
                               otraj[:, llk.C_CONSTR],
                               rtol=2e-5, atol=2e-3)


# ---------------------------------------------------------------------
# lon DP oracle (naive per-cell twin of eval_grid)
# ---------------------------------------------------------------------

def _lon_pp(spec):
    pp = lk.LonParams()
    pp.t_steps = spec["t_steps"]
    pp.s_steps = spec["s_steps"]
    pp.v_steps = spec["v_steps"]
    pp.a_steps = spec["a_steps"]
    pp.path_steps = spec["path_steps"]
    pp.s_max = 30.0
    pp.v_max = 12.0
    pp.path_step_size = 30.0 / (spec["path_steps"] - 1)
    return pp


def _lon_interp_path(path, dist, pp):
    P = len(path)
    a = dist / F(pp.path_step_size)
    i0 = int(np.clip(np.floor(a), 0, P - 1))
    i1 = int(np.clip(np.ceil(a), 0, P - 1))
    al = F(a - i0)
    return path[i0] * (F(1.0) - al) + path[i1] * al


def _lon_trilerp(nodes, s, v, a, pp, AL):
    S, V = nodes.shape[0], nodes.shape[1]
    x = np.clip((s - F(pp.s_min)) / F(pp.s_max - pp.s_min) * (S - 1),
                0.0, S - 1.0)
    y = np.clip((v - F(pp.v_min)) / F(pp.v_max - pp.v_min) * (V - 1),
                0.0, V - 1.0)
    z = np.clip((a - F(pp.a_min)) / F(pp.a_max - pp.a_min) * (AL - 1),
                0.0, AL - 1.0)
    x0, y0, z0 = int(np.floor(x)), int(np.floor(y)), int(np.floor(z))
    x1, y1, z1 = min(x0 + 1, S - 1), min(y0 + 1, V - 1), min(z0 + 1,
                                                             AL - 1)
    ax, ay, az = F(x - x0), F(y - y0), F(z - z0)
    c00 = nodes[x0, y0, z0] * (1 - ax) + nodes[x1, y0, z0] * ax
    c10 = nodes[x0, y1, z0] * (1 - ax) + nodes[x1, y1, z0] * ax
    c01 = nodes[x0, y0, z1] * (1 - ax) + nodes[x1, y0, z1] * ax
    c11 = nodes[x0, y1, z1] * (1 - ax) + nodes[x1, y1, z1] * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    return c0 * (1 - az) + c1 * az


def lon_oracle_backward(dist_path, path, pp):
    """Naive per-cell lon backward pass."""
    T, S, V = pp.t_steps, pp.s_steps, pp.v_steps
    A = pp.a_steps
    NB = 9
    dt = F(pp.dt)

    ss = F(pp.s_min) + np.arange(S, dtype=F) * F(pp.s_max - pp.s_min) \
        / F(S - 1)
    vs = F(pp.v_min) + np.arange(V, dtype=F) * F(pp.v_max - pp.v_min) \
        / F(V - 1)
    aas = F(pp.a_min) + np.arange(A, dtype=F) * F(pp.a_max - pp.a_min) \
        / F(A - 1)
    js = F(pp.j_min) + F(pp.j_max - pp.j_min) \
        * np.arange(NB, dtype=F) / F(NB - 1)

    nodes = np.zeros((T, S, V, A, 4), F)

    def state_terms(t_idx):
        cps = np.stack([_lon_interp_path(path, s, pp) for s in ss])
        v_max_s = cps[:, lk.PC_VMAX]
        s_dist = np.empty(S, F)
        for i_s in range(S):
            si = int(np.clip(round(
                (cps[i_s, lk.PC_S] - F(pp.s_min))
                / F(pp.s_max - pp.s_min) * (S - 1)), 0, S - 1))
            s_dist[i_s] = dist_path[t_idx, si] \
                - F(pp.length_veh) * F(0.6)
        return cps, v_max_s, s_dist

    # final slice
    cps, v_max_s, s_dist = state_terms(T - 1)
    for i_s, s in enumerate(ss):
        for i_v, v in enumerate(vs):
            for i_a, a in enumerate(aas):
                cost = (F(pp.w_a) * a * a
                        + F(pp.w_progress) * abs(F(1000.0) - s)
                        + F(pp.w_safety_dist) * max(
                            F(0.0), v * F(pp.time_gap) + F(pp.gap_min)
                            - s_dist[i_s]))
                nodes[T - 1, i_s, i_v, i_a, 0] = cost

    for i_t in range(T - 2, 0, -1):
        t_idx = min(i_t, T - 1)
        cps, v_max_s, s_dist = state_terms(t_idx)
        nxt = nodes[i_t + 1]
        for i_s, s in enumerate(ss):
            for i_v, v in enumerate(vs):
                for i_a, a in enumerate(aas):
                    state_cost = (F(pp.w_a) * a * a
                                  + F(pp.w_progress) * abs(F(1000.0) - s)
                                  + F(pp.w_safety_dist) * max(
                                      F(0.0), v * F(pp.time_gap)
                                      + F(pp.gap_min) - s_dist[i_s]))
                    state_constr = max(F(0.0), F(v - v_max_s[i_s]))

                    a_cost = np.empty(NB, F)
                    a_constr = np.empty(NB, F)
                    for k, j in enumerate(js):
                        s_change = max(F(0.0), F(
                            v * dt + F(0.5) * a * dt * dt
                            + j * dt ** 3 / F(6.0)))
                        sn = F(s + s_change)
                        vn = max(F(0.0), F(v + a * dt
                                           + F(0.5) * j * dt * dt))
                        an = F(a + j * dt)
                        nn = _lon_trilerp(nxt, sn, vn, an, pp, A)
                        cost = state_cost + nn[0]
                        constr = state_constr + nn[1]
                        cost += F(pp.w_snap) * F(nn[2] - j) ** 2
                        cost += F(pp.w_j) * F(j * dt) ** 2
                        v_max_n = _lon_interp_path(
                            path, sn, pp)[lk.PC_VMAX]
                        constr += max(F(0.0), F(vn - v_max_n))
                        constr += max(F(0.0), F(s_change - s_dist[i_s]))
                        constr += max(F(0.0), F(F(pp.a_min) - an))
                        constr += max(F(0.0), F(an - F(pp.a_max)))
                        a_cost[k] = cost
                        a_constr[k] = constr

                    cmin = a_constr.min()
                    costs = np.where(a_constr <= cmin, a_cost, np.inf)
                    kidx = int(np.argmin(costs))
                    nodes[i_t, i_s, i_v, i_a] = [
                        a_cost[kidx], cmin, js[kidx], 0.0]
    return nodes


def test_lon_backward_matches_exhaustive_oracle():
    spec = dict(t_steps=4, s_steps=7, v_steps=5, a_steps=3, path_steps=8)
    pp = _lon_pp(spec)
    T, S = pp.t_steps, pp.s_steps
    rng = np.random.default_rng(3)

    path = np.zeros((pp.path_steps, 7), F)
    dists = np.arange(pp.path_steps, dtype=F) * F(pp.path_step_size)
    path[:, lk.PC_X] = dists
    path[:, lk.PC_S] = dists
    path[:, lk.PC_VMAX] = 10.0 - 0.3 * np.arange(pp.path_steps)
    path[:, lk.PC_DIST] = dists

    dist_path = np.maximum(
        0.0, 18.0 - np.arange(S, dtype=F) * F(pp.s_step))[None, :] \
        + np.arange(T, dtype=F)[:, None] * 1.3
    dist_path = dist_path.astype(F)
    dist_path += rng.uniform(0.0, 0.1, dist_path.shape).astype(F)

    solver, _ = lk.make_lon_solver(spec)
    nodes, traj = solver(jnp.asarray(dist_path), jnp.asarray(path),
                         pp.dynamic_dict(),
                         jnp.zeros(7, jnp.float32))
    nodes = np.asarray(nodes)

    oracle = lon_oracle_backward(dist_path, path, pp)

    np.testing.assert_allclose(nodes[1:, ..., 0], oracle[1:, ..., 0],
                               rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(nodes[1:, ..., 1], oracle[1:, ..., 1],
                               rtol=2e-5, atol=2e-3)
    # best-jerk channel: EXACT choice (two-stage lexicographic argmin);
    # compare nearest-sample indices, tolerant to the ~2^-24 f32 sample
    # perturbation from XLA's reciprocal-multiply rewrite
    NB = 9
    js = F(pp.j_min) + F(pp.j_max - pp.j_min) \
        * np.arange(NB, dtype=F) / F(NB - 1)
    to_idx = lambda vals: np.argmin(
        np.abs(vals[..., None] - js), axis=-1)
    np.testing.assert_array_equal(
        to_idx(nodes[1:T - 1, ..., 2]),
        to_idx(oracle[1:T - 1, ..., 2]))
