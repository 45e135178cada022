"""
IDM sampling rollout planner kernel: closed-loop forward simulation of
lateral-offset candidates with Stanley lateral control and IDM longitudinal
control, evaluated for collisions, interactions and comfort.

JAX re-design of the reference's C++/OpenMP planner (reference:
library/src/idm_sampling.cpp): all candidates roll out in one
vmap-over-candidates lax.scan; the per-step leader lookups, stop-point
scans, reference-line projections and the SAT collision checks are
vectorized over the padded object set. The same kernel batches over
thousands of scenario rollouts per chip (vmap over a scenario axis).

Object tensors are padded to (O, P, K) with validity masks; the host-side
preprocessing (hull merge, prediction projections) lives in the planner
driver.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.ops.jgeometry import project_polyline, polygons_intersect


class IdmSamplingParams:
    """(reference: idm_sampling.hpp:4-55)"""

    def __init__(self):
        self.steps_t = 100
        self.dt = 0.1

        self.dead_time = 0.0

        self.lat_steps = 2
        self.d_safe_lat = 0.25
        self.d_safe_lat_path = 0.5
        self.d_comf_lat = 1.0

        self.k_stanley = 1.0
        self.v_offset_stanley = 1.0

        self.steer_angle_max = 0.7
        self.steer_rate_max = 0.6

        self.t_vel_lookahead = 2.0
        self.d_safe_min = 1.0
        self.t_headway_desired = 1.0
        self.a_break_comf = 1.5

        self.idm_exp_dcc = 4.0
        self.idm_exp_acc = 4.0

        self.k_p_s = 1.0
        self.k_p_v = 1.0

        self.a_max = 2.0
        self.a_min = -3.0
        self.j_max = 1.5
        self.j_min = -1.5

        self.d_next_inters_point = 1.0e6

        self.width_veh = 0.0
        self.length_veh = 0.0
        self.radius_veh = 0.0
        self.dist_front_veh = 0.0
        self.dist_back_veh = 0.0
        self.wheel_base = 4.0

        self.l_trg = 0.0
        self.w_l = 1.0
        self.w_a = 1.0
        self.w_lat_dist = 1.0

        self.dt_decision = 0.2

        self.enable_reverse = False

    def dynamic_dict(self):
        keys = ("dt", "dead_time", "d_safe_lat", "d_safe_lat_path",
                "d_comf_lat", "k_stanley", "v_offset_stanley",
                "steer_angle_max", "steer_rate_max", "t_vel_lookahead",
                "d_safe_min", "t_headway_desired", "a_break_comf",
                "idm_exp_dcc", "idm_exp_acc", "k_p_s", "k_p_v", "a_max",
                "a_min", "j_max", "j_min", "width_veh", "length_veh",
                "radius_veh", "dist_front_veh", "dist_back_veh",
                "wheel_base", "l_trg", "w_l", "w_a", "w_lat_dist")
        return {k: jnp.float32(getattr(self, k)) for k in keys}


# ref state fields: t, x, y, heading, v, a, s, l, d_right, d_left
R_T, R_X, R_Y, R_H, R_V, R_A, R_S, R_L, R_DR, R_DL = range(10)
# vehicle state fields: t, x, y, heading, steer, v, a, s, l
V_T, V_X, V_Y, V_H, V_ST, V_V, V_A, V_S, V_L = range(9)


def _bracket_by_t(ts, t):
    """Index and weight of the segment containing t on a sorted (P,)
    time grid.  Pure comparison/reduction form: ``searchsorted`` lowers
    to a binary-search loop of dynamic slices, while a sum of comparisons
    over P=16 is one fused elementwise pass."""
    n = ts.shape[0]
    i = jnp.clip(jnp.sum((ts <= t).astype(jnp.int32)) - 1, 0, n - 2)
    a = jnp.clip((t - ts[i]) / jnp.maximum(ts[i + 1] - ts[i], 1e-9),
                 0.0, 1.0)
    return i, a


def _two_hot(n, i, a, dtype):
    """Weight vector with (1-a) at i and a at i+1, built from
    comparisons: the ``zeros().at[i].set()`` form lowers to a
    scatter."""
    ar = jnp.arange(n)
    return (jnp.where(ar == i, 1.0 - a, 0.0)
            + jnp.where(ar == i + 1, a, 0.0)).astype(dtype)


def _interp_by_t(ts, values, t):
    """Linear interp of (P, ...) values by times ts (P,): the time axis
    is contracted with a 2-hot weight vector (small matmul on device)
    instead of gathered."""
    i, a = _bracket_by_t(ts, t)
    w = _two_hot(ts.shape[0], i, a, values.dtype)
    return jnp.tensordot(w, values, axes=([0], [0]))


def _interp_hulls_by_t(ts, hulls, t):
    """Linear interp of (P, K, 2) hull sweeps by times ts (P,).

    Same math as :func:`_interp_by_t`; the 2-hot contraction avoids
    both the scatter and the gather form, which materializes a
    (cand, T, O, P, K) fusion output under the candidate/time vmaps."""
    i, a = _bracket_by_t(ts, t)
    w = _two_hot(ts.shape[0], i, a, hulls.dtype)
    return jnp.einsum("p,pkc->kc", w, hulls)


def make_idm_kernel(spec):
    """spec: steps_t, n_ref (ref line points), n_obj, n_pred, n_hull
    (all static)."""
    T = spec["steps_t"]
    NR = spec["n_ref"]
    O = spec["n_obj"]
    P = spec["n_pred"]
    K = spec["n_hull"]
    f32 = jnp.float32

    def ref_lerp(ref_line, ref_step, s):
        n = NR
        q = s / ref_step
        i0 = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
        i1 = jnp.clip(jnp.ceil(q), 0, n - 1).astype(jnp.int32)
        a = jnp.clip(q - i0, 0.0, 1.0)
        if hasattr(a, "ndim") and a.ndim > 0:
            a = a[..., None]
        return ref_line[i0] * (1.0 - a) + ref_line[i1] * a

    def obj_hull_at(objs, t):
        """Merged prediction hulls lerped at time t -> (O, K, 2)."""
        def one(ts, hulls):
            return _interp_hulls_by_t(ts, hulls, t)
        return jax.vmap(one)(objs["pred_t"], objs["hull_preds"])

    def obj_state_at(objs, t):
        def one(ts, xy, heading, v):
            return (_interp_by_t(ts, xy, t),
                    _interp_by_t(ts, heading, t),
                    _interp_by_t(ts, v, t))
        return jax.vmap(one)(objs["pred_t"], objs["pred_xy"],
                             objs["pred_heading"], objs["pred_v"])

    def get_leader(ref_state, l_trg, objs, pp):
        """(idm_sampling.cpp:266-352). Returns (d_lead, v_lead, d_right,
        d_left)."""
        x, y, h, t, s = (ref_state[R_X], ref_state[R_Y], ref_state[R_H],
                         ref_state[R_T], ref_state[R_S])
        dirv = jnp.stack([jnp.cos(h), jnp.sin(h)])
        p0 = jnp.stack([x, y]) - dirv * pp["dist_back_veh"]
        ray_len = 200.0 + pp["dist_back_veh"]

        hulls = obj_hull_at(objs, t)                          # (O, K, 2)
        pos_o, head_o, v_o = obj_state_at(objs, t)            # (O,2),(O,),(O,)

        rel = hulls - p0                                       # (O, K, 2)
        arc = jnp.einsum("okd,d->ok", rel, dirv)               # along ray
        lat = rel[..., 1] * dirv[0] - rel[..., 0] * dirv[1]
        # signed distance: positive left of ray = cross(dir, rel)
        lat = dirv[0] * rel[..., 1] - dirv[1] * rel[..., 0]
        in_bounds = (arc > 0.0) & (arc < ray_len)

        valid = objs["valid"][:, None] & objs["on_local_map"][:, None]

        on_left = jnp.any((lat > 0.0) & valid, axis=1)         # (O,)
        on_right = jnp.any((lat < 0.0) & valid, axis=1)
        spans = on_left & on_right

        close_lat = jnp.abs(lat) < pp["width_veh"] / 2.0 + pp["d_safe_lat"]
        lead_mask = in_bounds & valid & (spans[:, None] | close_lat)
        dists = jnp.where(lead_mask, arc - pp["dist_back_veh"], jnp.inf)

        v_cand = v_o * jnp.cos(head_o - h)                     # (O,)
        flat = dists.reshape(-1)
        idx = jnp.argmin(flat)
        d_lead = flat[idx]
        v_lead = jnp.where(jnp.isfinite(d_lead),
                           v_cand[idx // K], 0.0)

        # lateral clearances ahead of the front bumper
        front_mask = in_bounds & valid & (arc < pp["dist_front_veh"])
        d_right = jnp.min(jnp.where(
            front_mask & (lat < 0.0) & ~spans[:, None],
            jnp.abs(lat), 100.0))
        d_left = jnp.min(jnp.where(
            front_mask & (lat > 0.0) & ~spans[:, None],
            jnp.abs(lat), 100.0))
        any_span_front = jnp.any(front_mask & spans[:, None])
        d_right = jnp.where(any_span_front, 0.0, d_right)
        d_left = jnp.where(any_span_front, 0.0, d_left)

        # additional hull-projection check on the target lane
        hp = jax.vmap(lambda ts, hps: _interp_by_t(ts, hps, t))(
            objs["pred_t"], objs["hull_projs"])                # (O, 4)
        on_lane = ((l_trg > hp[:, 2] - pp["width_veh"] / 2.0
                    - pp["d_safe_lat"])
                   & (l_trg < hp[:, 3] + pp["width_veh"] / 2.0
                      + pp["d_safe_lat"])
                   & (s < hp[:, 1]) & objs["valid"])
        lane_d = jnp.where(on_lane, hp[:, 0] - s, jnp.inf)
        li = jnp.argmin(lane_d)
        better = lane_d[li] < d_lead
        v_lead = jnp.where(better, v_o[li], v_lead)
        d_lead = jnp.where(better, lane_d[li], d_lead)

        d_lead = jnp.where(jnp.isfinite(d_lead), d_lead, 1e6)

        # stronger reaction to oncoming traffic
        d_lead = jnp.where(v_lead < 0.0, d_lead - 10.0, d_lead)
        v_lead = jnp.where(v_lead < 0.0, v_lead * 2.0, v_lead)
        return d_lead, v_lead, d_right, d_left

    def next_stop_point(ref_state, ref_line, ref_step, pp):
        """(idm_sampling.cpp:238-263)"""
        s = ref_state[R_S]
        l = ref_state[R_L]
        ss = jnp.arange(NR, dtype=f32) * ref_step
        ahead = ss >= s
        d = ss - s
        zero_v = ref_line[:, 4] == 0.0
        off_road = (l < -ref_line[:, 6]) | (l > ref_line[:, 5])
        d_min = jnp.min(jnp.where(ahead & zero_v, d, jnp.inf))
        d_min = jnp.minimum(d_min, jnp.min(jnp.where(
            ahead & off_road, d - pp["d_safe_min"], jnp.inf)))
        return d_min

    def rollout(init_ref, init_con, l_trg, d_stop0, dt_replan, ref_line,
                ref_step, linestrip, objs, pp):
        """One candidate closed-loop rollout (idm_sampling.cpp:354-530).
        Returns ref_states (T, 10), states (T, 9)."""

        def step(carry, idx_t):
            ref, con = carry

            # --- reference update ---
            v_trg_dist = ref[R_V] * pp["t_vel_lookahead"]
            steps = 25
            offs = jnp.arange(steps, dtype=f32) * (v_trg_dist / steps)
            v_trg = jnp.min(ref_lerp(ref_line, ref_step,
                                     ref[R_S] + offs)[:, 4])
            v_trg = jnp.maximum(0.001, v_trg)

            d_lead, v_lead, d_right, d_left = get_leader(ref, l_trg, objs,
                                                         pp)
            d_stop = next_stop_point(ref, ref_line, ref_step, pp)
            d_stop = jnp.minimum(d_stop0 - ref[R_S], d_stop)

            t_headway = pp["t_headway_desired"] * (
                1.0 - jnp.tanh((ref[R_L] - l_trg) * 0.5) ** 2)
            t_headway = jnp.maximum(t_headway, 0.5)

            s_net_stop = d_stop - pp["dist_front_veh"] + 1.0
            s_star_stop = (1.0 + ref[R_V] * t_headway
                           + ref[R_V] ** 2
                           / (2 * jnp.sqrt(pp["a_max"]
                                           * pp["a_break_comf"])))
            inter_term = s_star_stop / s_net_stop

            s_net = d_lead - pp["dist_front_veh"]
            s_star = (pp["d_safe_min"] + ref[R_V] * t_headway
                      + ref[R_V] * (ref[R_V] - v_lead)
                      / (2 * jnp.sqrt(pp["a_max"] * pp["a_break_comf"])))
            inter_term = jnp.where(d_lead < d_stop,
                                   jnp.maximum(s_star / s_net, inter_term),
                                   inter_term)

            v_rel = ref[R_V] / v_trg
            exp = jnp.where(v_rel < 1.0, pp["idm_exp_acc"],
                            pp["idm_exp_dcc"])
            a_idm = pp["a_max"] * (1.0 - v_rel ** exp - inter_term ** 2)

            rp = ref_lerp(ref_line, ref_step, ref[R_S])
            # ref_line channels: x, y, heading, k, v_max, d_left, d_right
            l_change = jnp.clip(l_trg - ref[R_L], -1.5, 1.5)
            nl = ref[R_L] + l_change * pp["dt"]
            s_rate = (ref[R_V] * jnp.cos(ref[R_H] - rp[2])
                      / (1.0 - ref[R_L] * rp[3]))
            ns = ref[R_S] + s_rate * pp["dt"]
            nrp = ref_lerp(ref_line, ref_step, ns)

            heading_rel = _short_angle(ref[R_H], rp[2])
            heading_rel = heading_rel + s_rate * rp[3] * pp["dt"]
            nh = nrp[2] + heading_rel

            dt_control = jnp.where(idx_t == 0, dt_replan, pp["dt"])

            lane_changing = (jnp.abs(ref[R_L] - l_trg) > 0.5) \
                & (ref[R_V] > 1.0) & (ref[R_V] < 5.0)
            a_idm = jnp.where(lane_changing, jnp.minimum(0.0, a_idm),
                              a_idm)

            j = (a_idm - ref[R_A]) / jnp.maximum(dt_control, 1e-6)
            j_standstill = jnp.clip(j, pp["j_min"],
                                    -ref[R_A] / jnp.maximum(dt_control,
                                                            1e-6))
            j = jnp.where((ref[R_V] == 0.0) & (ref[R_A] < 0.0),
                          j_standstill,
                          jnp.clip(j, pp["j_min"], pp["j_max"]))

            a_new = jnp.clip(ref[R_A] + j * dt_control,
                             pp["a_min"], pp["a_max"])

            ref_out = ref.at[R_A].set(a_new)
            ref_out = ref_out.at[R_DR].set(d_right)
            ref_out = ref_out.at[R_DL].set(d_left)

            nref = jnp.zeros_like(ref)
            nref = nref.at[R_T].set(ref[R_T] + pp["dt"])
            nref = nref.at[R_L].set(nl)
            nref = nref.at[R_S].set(ns)
            nref = nref.at[R_H].set(nh)
            nref = nref.at[R_X].set(nrp[0] - nl * jnp.sin(nrp[2]))
            nref = nref.at[R_Y].set(nrp[1] + nl * jnp.cos(nrp[2]))
            nref = nref.at[R_V].set(jnp.maximum(
                0.0, ref[R_V] + a_new * pp["dt"]))
            nref = nref.at[R_A].set(a_new)

            # --- following controller (Stanley + PD) ---
            rs = ref_out
            rp_con = ref_lerp(ref_line, ref_step, con[V_S])
            k_adj = jnp.where(jnp.abs(rp_con[3]) > 1e-4,
                              1.0 / (1.0 / rp_con[3] + con[V_L]),
                              rp_con[3])
            steer_ref = jnp.arctan(k_adj * pp["wheel_base"])
            angle_diff = _short_angle(con[V_H], rs[R_H])
            lat_diff = rs[R_L] - con[V_L]
            steer_angle = steer_ref + angle_diff + jnp.arctan(
                pp["k_stanley"] * lat_diff
                / (pp["v_offset_stanley"] + con[V_V]))
            steer_angle = jnp.clip(steer_angle, -pp["steer_angle_max"],
                                   pp["steer_angle_max"])
            steer_rate = jnp.clip(
                (steer_angle - con[V_ST]) / jnp.maximum(dt_control, 1e-6),
                -pp["steer_rate_max"], pp["steer_rate_max"])
            do_steer = (con[V_V] > 1.0) | (con[V_A] > 0.5) \
                | (jnp.abs(lat_diff) > 0.1)
            new_steer = jnp.where(do_steer,
                                  con[V_ST] + steer_rate * dt_control,
                                  con[V_ST])

            err_s = rs[R_S] - con[V_S]
            err_v = rs[R_V] - con[V_V]
            a_con = rs[R_A] + err_s * pp["k_p_s"] + err_v * pp["k_p_v"]

            con_out = con.at[V_ST].set(new_steer)
            con_out = con_out.at[V_A].set(a_con)

            ncon = jnp.zeros_like(con)
            nv = jnp.maximum(0.0, con[V_V] + pp["dt"] * a_con)
            nheading = con[V_H] + pp["dt"] * nv * jnp.tan(new_steer) \
                / pp["wheel_base"]
            nx = con[V_X] + pp["dt"] * nv * jnp.cos(nheading)
            ny = con[V_Y] + pp["dt"] * nv * jnp.sin(nheading)
            proj = project_polyline(linestrip, jnp.stack([nx, ny]))
            ncon = ncon.at[V_T].set(con[V_T] + pp["dt"])
            ncon = ncon.at[V_A].set(a_con)
            ncon = ncon.at[V_ST].set(new_steer)
            ncon = ncon.at[V_V].set(nv)
            ncon = ncon.at[V_H].set(nheading)
            ncon = ncon.at[V_X].set(nx)
            ncon = ncon.at[V_Y].set(ny)
            ncon = ncon.at[V_S].set(proj["arc_len"])
            ncon = ncon.at[V_L].set(proj["distance"])

            return (nref, ncon), (ref_out, con_out)

        (last_ref, last_con), (refs, cons) = jax.lax.scan(
            step, (init_ref, init_con), jnp.arange(T - 1))
        ref_states = jnp.concatenate([refs, last_ref[None]], axis=0)
        states = jnp.concatenate([cons, last_con[None]], axis=0)
        return ref_states, states

    def _short_angle(a0, a1):
        m = 2 * jnp.pi
        da = jnp.mod(a1 - a0, m)
        return jnp.mod(2 * da, m) - da

    # ---- lanes-form rollout -------------------------------------------
    # Same semantics as `rollout` under vmap (validated against it in
    # tests/test_idm_kernel.py), restructured like evaluate_lanes: the
    # candidate axis C is the MINOR dimension of every tensor, the
    # object hulls/states at each (shared) step time are computed once
    # for all candidates, and the ref-line lookups gather from 1-D
    # channel tables with C-minor index arrays.

    def _ref_ch_lerp(ref_line, ref_step, s, ch):
        """Lerp one ref-line channel at stations s (..., C), gather
        form (used where the index count is small)."""
        q = s / ref_step
        i0 = jnp.clip(jnp.floor(q), 0, NR - 1).astype(jnp.int32)
        i1 = jnp.clip(jnp.ceil(q), 0, NR - 1).astype(jnp.int32)
        a = jnp.clip(q - i0, 0.0, 1.0)
        tab = ref_line[:, ch]
        return tab[i0] * (1.0 - a) + tab[i1] * a

    def _ref_lerp_2hot(ref_line, ref_step, s, chs):
        """Lerp several ref-line channels at stations s (C,) via a
        two-hot contraction: builds the (NR, C) lerp-weight matrix from
        comparisons and contracts it with the channel table (one matrix
        product instead of a per-element gather inside the rollout
        scan).  Returns (len(chs), C)."""
        q = s / ref_step
        i0 = jnp.clip(jnp.floor(q), 0.0, NR - 1.0)
        i1 = jnp.clip(jnp.ceil(q), 0.0, NR - 1.0)
        a = jnp.clip(q - i0, 0.0, 1.0)
        ar = jnp.arange(NR, dtype=f32)[:, None]
        w = (jnp.where(ar == i0, 1.0 - a, 0.0)
             + jnp.where(ar == i1, a, 0.0))
        return jnp.einsum("nc,nk->kc", w, ref_line[:, chs])

    def rollout_lanes(init_ref, init_con, l_trg, d_stop0, dt_replan,
                      ref_line, ref_step, linestrip, objs, pp):
        """All-candidate closed-loop rollout; l_trg, d_stop0: (C,).
        Returns ref_states (C, T, 10), states (C, T, 9)."""
        C = l_trg.shape[0]
        bcast = lambda v: jnp.broadcast_to(v[:, None], v.shape + (C,))
        ref0 = bcast(init_ref)                        # (10, C)
        con0 = bcast(init_con)                        # (9, C)

        # shared per-step object data on the common time grid; built by
        # the same f32 accumulation the per-step carry performs, so the
        # interp brackets match the vmap rollout bit-for-bit
        _, step_ts = jax.lax.scan(
            lambda c, _: (c + pp["dt"], c), init_ref[R_T],
            None, length=T - 1)
        hulls_S = jax.vmap(lambda t: obj_hull_at(objs, t))(step_ts)
        pos_S, head_S, v_S = jax.vmap(
            lambda t: obj_state_at(objs, t))(step_ts)  # (T-1,O,·)
        hp_S = jax.vmap(lambda t: jax.vmap(
            lambda ts, hps: _interp_by_t(ts, hps, t))(
            objs["pred_t"], objs["hull_projs"]))(step_ts)  # (T-1,O,4)

        # next zero-v stop cell: position of the first pinned-zero ref
        # cell at-or-after each grid index (suffix scan, shared); kept
        # as a finite value + inf-mask pair so the one-hot contraction
        # below never multiplies 0 x inf
        ss_grid = jnp.arange(NR, dtype=f32) * ref_step
        zero_pos = jnp.where(ref_line[:, 4] == 0.0, ss_grid, jnp.inf)
        next_zero = jax.lax.associative_scan(
            jnp.minimum, zero_pos, reverse=True)       # (NR,)
        nz_inf = jnp.isinf(next_zero).astype(f32)
        nz_fin = jnp.where(jnp.isinf(next_zero), 0.0, next_zero)

        seg_a = linestrip[:-1]                         # (S, 2)
        seg_v = linestrip[1:] - linestrip[:-1]
        seg_vv = jnp.maximum(jnp.sum(seg_v * seg_v, axis=-1), 1e-12)
        seg_len = jnp.sqrt(seg_vv)
        seg_arc0 = jnp.concatenate(
            [jnp.zeros(1, f32), jnp.cumsum(seg_len)])[:-1]
        seg_ang = jnp.arctan2(seg_v[:, 1], seg_v[:, 0])
        n_seg = seg_a.shape[0]

        valid_o = objs["valid"] & objs["on_local_map"]  # (O,)

        def get_leader_lanes(x, y, h, s, l_trg, hx, hy, pos_o, head_o,
                             v_o, hp):
            """(get_leader, lanes form). x..s: (C,); hx/hy: (O,K);
            pos_o: (O,2); hp: (O,4). Returns four (C,) arrays."""
            dx, dy = jnp.cos(h), jnp.sin(h)            # (C,)
            p0x = x - dx * pp["dist_back_veh"]
            p0y = y - dy * pp["dist_back_veh"]
            ray_len = 200.0 + pp["dist_back_veh"]

            rx = hx[..., None] - p0x                   # (O, K, C)
            ry = hy[..., None] - p0y
            arc = rx * dx + ry * dy
            lat = dx * ry - dy * rx
            in_bounds = (arc > 0.0) & (arc < ray_len)

            vmask = valid_o[:, None, None]             # (O, 1, 1)
            on_left = jnp.any((lat > 0.0) & vmask, axis=1)   # (O, C)
            on_right = jnp.any((lat < 0.0) & vmask, axis=1)
            spans = on_left & on_right                 # (O, C)

            close_lat = jnp.abs(lat) < pp["width_veh"] / 2.0 \
                + pp["d_safe_lat"]
            lead_mask = in_bounds & vmask & (spans[:, None] | close_lat)
            dists = jnp.where(lead_mask, arc - pp["dist_back_veh"],
                              jnp.inf)                 # (O, K, C)

            v_cand = v_o[:, None] * jnp.cos(head_o[:, None] - h)
            flat = dists.reshape(O * K, C)
            idx = jnp.argmin(flat, axis=0)             # (C,)
            d_lead = jnp.min(flat, axis=0)
            oh_o = jax.nn.one_hot(idx // K, O, axis=0, dtype=f32)
            v_at = jnp.sum(oh_o * v_cand, axis=0)
            v_lead = jnp.where(jnp.isfinite(d_lead), v_at, 0.0)

            front_mask = in_bounds & vmask & (arc < pp["dist_front_veh"])
            nspan = ~spans[:, None]
            d_right = jnp.min(jnp.where(front_mask & (lat < 0.0) & nspan,
                                        jnp.abs(lat), 100.0), axis=(0, 1))
            d_left = jnp.min(jnp.where(front_mask & (lat > 0.0) & nspan,
                                       jnp.abs(lat), 100.0), axis=(0, 1))
            any_span_front = jnp.any(front_mask & spans[:, None],
                                     axis=(0, 1))
            d_right = jnp.where(any_span_front, 0.0, d_right)
            d_left = jnp.where(any_span_front, 0.0, d_left)

            on_lane = ((l_trg > hp[:, 2:3] - pp["width_veh"] / 2.0
                        - pp["d_safe_lat"])
                       & (l_trg < hp[:, 3:4] + pp["width_veh"] / 2.0
                          + pp["d_safe_lat"])
                       & (s < hp[:, 1:2])
                       & objs["valid"][:, None])       # (O, C)
            lane_d = jnp.where(on_lane, hp[:, 0:1] - s, jnp.inf)
            li = jnp.argmin(lane_d, axis=0)            # (C,)
            lane_best = jnp.min(lane_d, axis=0)
            oh_l = jax.nn.one_hot(li, O, axis=0, dtype=f32)
            v_li = jnp.sum(oh_l * v_o[:, None], axis=0)
            better = lane_best < d_lead
            v_lead = jnp.where(better, v_li, v_lead)
            d_lead = jnp.where(better, lane_best, d_lead)

            d_lead = jnp.where(jnp.isfinite(d_lead), d_lead, 1e6)
            d_lead = jnp.where(v_lead < 0.0, d_lead - 10.0, d_lead)
            v_lead = jnp.where(v_lead < 0.0, v_lead * 2.0, v_lead)
            return d_lead, v_lead, d_right, d_left

        def project_linestrip_lanes(px, py):
            """project_polyline onto the shared ref linestrip, lanes
            form: px, py (C,) -> (arc_len, distance) each (C,)."""
            pvx = px - seg_a[:, None, 0]               # (S, C)
            pvy = py - seg_a[:, None, 1]
            q = (pvx * seg_v[:, None, 0] + pvy * seg_v[:, None, 1]) \
                / seg_vv[:, None]
            qc = jnp.clip(q, 0.0, 1.0)
            fx = seg_a[:, None, 0] + seg_v[:, None, 0] * qc
            fy = seg_a[:, None, 1] + seg_v[:, None, 1] * qc
            d2 = (px - fx) ** 2 + (py - fy) ** 2
            best = jnp.argmin(d2, axis=0)              # (C,)
            sel = jax.nn.one_hot(best, n_seg, axis=0, dtype=f32)
            pick = lambda a: jnp.sum(a * sel, axis=0)
            pick_sh = lambda tab: jnp.sum(tab[:, None] * sel, axis=0)
            fx_b, fy_b = pick(fx), pick(fy)
            dist = jnp.sqrt(pick(d2))
            arc = pick_sh(seg_arc0) + jnp.sqrt(
                (fx_b - pick_sh(seg_a[:, 0])) ** 2
                + (fy_b - pick_sh(seg_a[:, 1])) ** 2)
            ang = pick_sh(seg_ang)
            ox, oy = fx_b - px, fy_b - py
            on = jnp.sqrt(ox ** 2 + oy ** 2)
            inv = 1.0 / jnp.maximum(on, 1e-12)
            sign_neg = (jnp.cos(ang) * (-oy * inv)
                        + jnp.sin(ang) * (ox * inv)) <= 0.0
            dist = jnp.where(sign_neg, -dist, dist)
            dist = jnp.where(on < 1e-9, 0.0, dist)
            return arc, dist

        def step(carry, inp):
            ref, con = carry                           # (10,C), (9,C)
            idx_t, hx, hy, pos_o, head_o, v_o, hp = inp

            # --- reference update ---
            v_trg_dist = ref[R_V] * pp["t_vel_lookahead"]
            v_trg = jnp.inf
            for k in range(25):
                sk = ref[R_S] + f32(k) * (v_trg_dist / 25)
                v_trg = jnp.minimum(
                    v_trg, _ref_lerp_2hot(ref_line, ref_step, sk,
                                          (4,))[0])
            v_trg = jnp.maximum(0.001, v_trg)

            d_lead, v_lead, d_right, d_left = get_leader_lanes(
                ref[R_X], ref[R_Y], ref[R_H], ref[R_S], l_trg,
                hx, hy, pos_o, head_o, v_o, hp)

            # next_stop_point, lanes form: the zero-v leg reads the
            # precomputed suffix-min table; the off-road leg keeps the
            # full (NR, C) mask (it depends on the candidate's l)
            s, l = ref[R_S], ref[R_L]
            i0 = jnp.clip(jnp.ceil(s / ref_step), 0.0, NR - 1.0)
            oh0 = (jnp.arange(NR, dtype=f32)[:, None] == i0).astype(f32)
            d_zero = jnp.where(
                jnp.einsum("nc,n->c", oh0, nz_inf) > 0.0, jnp.inf,
                jnp.einsum("nc,n->c", oh0, nz_fin) - s)
            ahead = ss_grid[:, None] >= s
            off_road = (l < -ref_line[:, 6:7]) | (l > ref_line[:, 5:6])
            d_off = jnp.min(jnp.where(ahead & off_road,
                                      ss_grid[:, None] - s
                                      - pp["d_safe_min"], jnp.inf),
                            axis=0)
            d_stop = jnp.minimum(d_zero, d_off)
            d_stop = jnp.minimum(d_stop0 - s, d_stop)

            t_headway = pp["t_headway_desired"] * (
                1.0 - jnp.tanh((ref[R_L] - l_trg) * 0.5) ** 2)
            t_headway = jnp.maximum(t_headway, 0.5)

            s_net_stop = d_stop - pp["dist_front_veh"] + 1.0
            s_star_stop = (1.0 + ref[R_V] * t_headway
                           + ref[R_V] ** 2
                           / (2 * jnp.sqrt(pp["a_max"]
                                           * pp["a_break_comf"])))
            inter_term = s_star_stop / s_net_stop

            s_net = d_lead - pp["dist_front_veh"]
            s_star = (pp["d_safe_min"] + ref[R_V] * t_headway
                      + ref[R_V] * (ref[R_V] - v_lead)
                      / (2 * jnp.sqrt(pp["a_max"]
                                      * pp["a_break_comf"])))
            inter_term = jnp.where(d_lead < d_stop,
                                   jnp.maximum(s_star / s_net,
                                               inter_term), inter_term)

            v_rel = ref[R_V] / v_trg
            exp = jnp.where(v_rel < 1.0, pp["idm_exp_acc"],
                            pp["idm_exp_dcc"])
            a_idm = pp["a_max"] * (1.0 - v_rel ** exp - inter_term ** 2)

            rp = _ref_lerp_2hot(ref_line, ref_step, ref[R_S],
                                (2, 3))                # heading, k
            l_change = jnp.clip(l_trg - ref[R_L], -1.5, 1.5)
            nl = ref[R_L] + l_change * pp["dt"]
            s_rate = (ref[R_V] * jnp.cos(ref[R_H] - rp[0])
                      / (1.0 - ref[R_L] * rp[1]))
            ns = ref[R_S] + s_rate * pp["dt"]
            nrp = _ref_lerp_2hot(ref_line, ref_step, ns,
                                 (0, 1, 2))            # x, y, heading

            heading_rel = _short_angle(ref[R_H], rp[0])
            heading_rel = heading_rel + s_rate * rp[1] * pp["dt"]
            nh = nrp[2] + heading_rel

            dt_control = jnp.where(idx_t == 0, dt_replan, pp["dt"])

            lane_changing = (jnp.abs(ref[R_L] - l_trg) > 0.5) \
                & (ref[R_V] > 1.0) & (ref[R_V] < 5.0)
            a_idm = jnp.where(lane_changing, jnp.minimum(0.0, a_idm),
                              a_idm)

            j = (a_idm - ref[R_A]) / jnp.maximum(dt_control, 1e-6)
            j_standstill = jnp.clip(j, pp["j_min"],
                                    -ref[R_A]
                                    / jnp.maximum(dt_control, 1e-6))
            j = jnp.where((ref[R_V] == 0.0) & (ref[R_A] < 0.0),
                          j_standstill,
                          jnp.clip(j, pp["j_min"], pp["j_max"]))
            a_new = jnp.clip(ref[R_A] + j * dt_control,
                             pp["a_min"], pp["a_max"])

            ref_out = ref.at[R_A].set(a_new)
            ref_out = ref_out.at[R_DR].set(d_right)
            ref_out = ref_out.at[R_DL].set(d_left)

            nref = jnp.stack([
                ref[R_T] + pp["dt"],
                nrp[0] - nl * jnp.sin(nrp[2]),
                nrp[1] + nl * jnp.cos(nrp[2]),
                nh,
                jnp.maximum(0.0, ref[R_V] + a_new * pp["dt"]),
                a_new,
                ns,
                nl,
                jnp.zeros_like(nl),
                jnp.zeros_like(nl)])

            # --- following controller (Stanley + PD) ---
            rs = ref_out
            k_con = _ref_lerp_2hot(ref_line, ref_step, con[V_S],
                                   (3,))[0]
            k_adj = jnp.where(jnp.abs(k_con) > 1e-4,
                              1.0 / (1.0 / k_con + con[V_L]), k_con)
            steer_ref = jnp.arctan(k_adj * pp["wheel_base"])
            angle_diff = _short_angle(con[V_H], rs[R_H])
            lat_diff = rs[R_L] - con[V_L]
            steer_angle = steer_ref + angle_diff + jnp.arctan(
                pp["k_stanley"] * lat_diff
                / (pp["v_offset_stanley"] + con[V_V]))
            steer_angle = jnp.clip(steer_angle, -pp["steer_angle_max"],
                                   pp["steer_angle_max"])
            steer_rate = jnp.clip(
                (steer_angle - con[V_ST])
                / jnp.maximum(dt_control, 1e-6),
                -pp["steer_rate_max"], pp["steer_rate_max"])
            do_steer = (con[V_V] > 1.0) | (con[V_A] > 0.5) \
                | (jnp.abs(lat_diff) > 0.1)
            new_steer = jnp.where(do_steer,
                                  con[V_ST] + steer_rate * dt_control,
                                  con[V_ST])

            err_s = rs[R_S] - con[V_S]
            err_v = rs[R_V] - con[V_V]
            a_con = rs[R_A] + err_s * pp["k_p_s"] + err_v * pp["k_p_v"]

            con_out = con.at[V_ST].set(new_steer)
            con_out = con_out.at[V_A].set(a_con)

            nv = jnp.maximum(0.0, con[V_V] + pp["dt"] * a_con)
            nheading = con[V_H] + pp["dt"] * nv * jnp.tan(new_steer) \
                / pp["wheel_base"]
            nx = con[V_X] + pp["dt"] * nv * jnp.cos(nheading)
            ny = con[V_Y] + pp["dt"] * nv * jnp.sin(nheading)
            arc, lat = project_linestrip_lanes(nx, ny)
            ncon = jnp.stack([
                con[V_T] + pp["dt"], nx, ny, nheading, new_steer,
                nv, a_con, arc, lat])

            return (nref, ncon), (ref_out, con_out)

        (last_ref, last_con), (refs, cons) = jax.lax.scan(
            step, (ref0, con0),
            (jnp.arange(T - 1),
             hulls_S[..., 0], hulls_S[..., 1],
             pos_S, head_S, v_S, hp_S))
        ref_states = jnp.concatenate([refs, last_ref[None]], axis=0)
        states = jnp.concatenate([cons, last_con[None]], axis=0)
        # (T, 10, C) -> (C, T, 10) for the evaluate/driver API
        return (jnp.transpose(ref_states, (2, 0, 1)),
                jnp.transpose(states, (2, 0, 1)))

    def vehicle_hull(state, pp):
        base = jnp.stack([
            jnp.stack([pp["dist_back_veh"], -pp["width_veh"] / 2]),
            jnp.stack([pp["dist_front_veh"], -pp["width_veh"] / 2]),
            jnp.stack([pp["dist_front_veh"], pp["width_veh"] / 2]),
            jnp.stack([pp["dist_back_veh"], pp["width_veh"] / 2])])
        c, s_ = jnp.cos(state[V_H]), jnp.sin(state[V_H])
        rot = jnp.stack([jnp.stack([c, -s_]), jnp.stack([s_, c])])
        return base @ rot.T + jnp.stack([state[V_X], state[V_Y]])

    def evaluate(ref_states, states, l_trg, objs, ref_line, ref_step, pp,
                 l_trg_global):
        """(idm_sampling.cpp:531-639). Returns cost tuple."""
        ts = states[:, V_T]

        hulls_v = jax.vmap(lambda s: vehicle_hull(s, pp))(states)  # (T,4,2)

        # collision with predicted hulls
        def coll_at(state, hull_v):
            t = state[V_T]
            hulls_o = obj_hull_at(objs, t)                   # (O, K, 2)
            pos_o, _, v_o = obj_state_at(objs, t)
            l_off = pp["length_veh"] / 2.0 - pp["dist_back_veh"]
            center = jnp.stack([
                state[V_X] + l_off * jnp.cos(state[V_H]),
                state[V_Y] + l_off * jnp.sin(state[V_H])])
            dist = jnp.linalg.norm(pos_o - center, axis=-1)
            near = (dist <= pp["radius_veh"] + objs["radius_hull"] + v_o) \
                & objs["valid"]
            hit = polygons_intersect(
                jnp.broadcast_to(hull_v, (O, 4, 2)), hulls_o) & near
            return jnp.any(hit)

        colls = jax.vmap(coll_at)(states, hulls_v)            # (T,)
        any_coll = jnp.any(colls)
        first_coll = jnp.argmax(colls)
        t_coll = ts[first_coll]

        invalid = any_coll & (t_coll < 3.0)
        cost_collision = jnp.where(any_coll, T * pp["dt"] - t_coll, 0.0)

        # interaction with oncoming objects (accumulated until collision)
        def inter_at(state):
            def per_obj(path, dists, ts_o, heads, hulls, radius, valid):
                proj = project_polyline(path,
                                        jnp.stack([state[V_X], state[V_Y]]))
                ok = proj["in_bounds"] & valid & (
                    jnp.abs(proj["distance"])
                    <= pp["radius_veh"] + radius)
                # prediction at the matched station
                i, a = _bracket_by_t(dists, proj["arc_len"])
                tt = ts_o[i] * (1 - a) + ts_o[i + 1] * a
                hull_p = _interp_hulls_by_t(ts_o, hulls, tt)
                hull_v = vehicle_hull(state, pp)
                hit = polygons_intersect(hull_v, hull_p)
                oncoming = jnp.cos(state[V_H] - proj["angle"]) < 0.0
                return jnp.where(ok & hit & oncoming,
                                 1.0 / (1.0 + jnp.abs(proj["distance"])),
                                 0.0)
            vals = jax.vmap(per_obj)(
                objs["pred_xy"], objs["pred_dists"], objs["pred_t"],
                objs["pred_heading"], objs["hull_preds"],
                objs["radius_hull"], objs["valid"])
            return jnp.sum(vals)

        inter = jax.vmap(inter_at)(states)
        before_coll = jnp.arange(T) < jnp.where(any_coll, first_coll, T)
        cost_interaction = jnp.sum(jnp.where(before_coll, inter, 0.0))

        # distance cost
        seg = jnp.linalg.norm(jnp.diff(states[:, [V_X, V_Y]], axis=0),
                              axis=-1)
        cost_distance = 1000.0 - jnp.sum(seg)

        # comfort costs
        cost = pp["w_l"] * (l_trg_global - l_trg) ** 2
        min_dl = jnp.min(ref_states[:-1, R_DL])
        min_dr = jnp.min(ref_states[:-1, R_DR])
        cost += jnp.where(min_dl < pp["d_comf_lat"],
                          pp["w_lat_dist"] * (pp["d_comf_lat"] - min_dl)
                          / pp["d_comf_lat"], 0.0)
        cost += jnp.where(min_dr < pp["d_comf_lat"],
                          pp["w_lat_dist"] * (pp["d_comf_lat"] - min_dr)
                          / pp["d_comf_lat"], 0.0)
        cost += jnp.sum(pp["w_a"] * jnp.minimum(0.0, states[:, V_A]) ** 2)

        # road-edge penalty
        rp = ref_lerp(ref_line, ref_step, states[:, V_S])
        margin = pp["width_veh"] / 2.0 * np.sqrt(2.0)
        edge = (jnp.sum(states[:, V_L] > rp[:, 5] - margin)
                + jnp.sum(states[:, V_L] < -rp[:, 6] + margin)).astype(f32)

        # on collision the reference skips distance/comfort and edge costs
        cost_collision = cost_collision + jnp.where(any_coll, 0.0, edge)
        cost = jnp.where(any_coll, 0.0, cost)
        cost_distance = jnp.where(any_coll, 0.0, cost_distance)
        cost_interaction = jnp.where(any_coll, cost_interaction,
                                     cost_interaction)

        return dict(cost=cost, cost_distance=cost_distance,
                    cost_interaction=cost_interaction,
                    cost_collision=cost_collision,
                    invalid=invalid)

    # ---- lanes-form evaluate ------------------------------------------
    # Same semantics as `evaluate` (validated against it in
    # tests/test_idm_kernel.py), restructured for throughput:
    #
    #  * everything shared across candidates is computed ONCE — the
    #    rollout time grid is identical for every candidate (the scan
    #    adds pp["dt"] per step to the same init state), so the object
    #    hulls/states sampled on it, their edge normals and their
    #    self-projections are candidate-independent;
    #  * the candidate axis C lives in the MINOR dimension of every
    #    per-candidate tensor (the vmap form builds (C, T, O, K, 2)
    #    tensors whose minor dims are 2 and 16);
    #  * the per-time-step screens run under one lax.scan, so their
    #    intermediates are (O, K, C)-sized instead of materializing
    #    (C, T, O, K, ...) in device memory;
    #  * the ego hull is a rectangle, so its side of every SAT test
    #    collapses to an ego-frame interval test and an analytic
    #    center±extent projection onto the obstacle's edge normals —
    #    exactly equivalent to the generic polygon test (same trick as
    #    the poly-sampling screen, poly_kernel.py).

    S_SEG = P - 1

    def _rect_geom(pp):
        db, df = pp["dist_back_veh"], pp["dist_front_veh"]
        hw = pp["width_veh"] / 2.0
        return (jnp.minimum(db, df), jnp.maximum(db, df), hw,
                (db + df) / 2.0, jnp.abs(df - db) / 2.0)

    def _rect_sat_hit(cx, cy, ch, px, py, n_x, n_y, edge_ok,
                      hmin, hmax, pp):
        """Ego rect at (cx, cy, ch) [(C,) or broadcastable] vs convex
        hulls with vertices (px, py) [(O, K, C)], edge normals
        (n_x, n_y) [(O, K, C)], per-edge validity edge_ok and hull
        self-projections hmin/hmax [(O, K, C)] -> hit (O, C).

        Mirrors polygons_intersect(ego_hull, hull): the ego-edge axes
        become the ego-frame interval test; the hull-edge axes use the
        analytic rectangle projection."""
        x_lo, x_hi, hw, mid_x, half_x = _rect_geom(pp)
        ux, uy = jnp.cos(ch), jnp.sin(ch)

        # hull vertices in the ego frame
        rx, ry = px - cx, py - cy
        hx = rx * ux + ry * uy                      # (O, K, C)
        hy = -rx * uy + ry * ux
        gap_rect = ((jnp.max(hx, axis=1) < x_lo)
                    | (jnp.min(hx, axis=1) > x_hi)
                    | (jnp.max(hy, axis=1) < -hw)
                    | (jnp.min(hy, axis=1) > hw))   # (O, C)

        # hull edge normals: rectangle projection is center ± extent
        cn = cx * n_x + cy * n_y                    # (O, K, C)
        un = ux * n_x + uy * n_y                    # u·n (ego frame n)
        vn = -uy * n_x + ux * n_y
        ecen = cn + mid_x * un
        eext = half_x * jnp.abs(un) + hw * jnp.abs(vn)
        gap_edge = (((ecen + eext < hmin) | (hmax < ecen - eext))
                    & edge_ok)
        return ~(gap_rect | jnp.any(gap_edge, axis=1))

    def _hull_edges(px, py):
        """Edge normals + self-projections of convex hulls given vertex
        coordinate arrays with the vertex axis at position 1
        [(O, K, C) or (O, K)]. Returns (n_x, n_y, edge_ok, hmin, hmax)
        where hmin/hmax are min/max over vertices of p·n per edge."""
        ex = jnp.roll(px, -1, axis=1) - px
        ey = jnp.roll(py, -1, axis=1) - py
        edge_ok = ex * ex + ey * ey > 1e-18
        n_x, n_y = -ey, ex
        # q[o, j, k, ...] = p_k · n_j
        q = (n_x[:, :, None] * px[:, None, :]
             + n_y[:, :, None] * py[:, None, :])
        return n_x, n_y, edge_ok, jnp.min(q, axis=2), jnp.max(q, axis=2)

    def evaluate_lanes(ref_states, states, l_trgs, objs, ref_line,
                       ref_step, pp, l_trg_global):
        """Lanes-form evaluate over all candidates at once.

        ref_states: (C, T, 10); states: (C, T, 9); l_trgs: (C,).
        Returns the same dict of (C,) arrays as `evaluate`."""
        C = states.shape[0]
        ts = states[0, :, V_T]                       # shared time grid

        # -- shared per-time-slice object data (no C axis) -----------
        hulls_T = jax.vmap(lambda t: obj_hull_at(objs, t))(ts)  # (T,O,K,2)
        pos_T, _, v_T = jax.vmap(lambda t: obj_state_at(objs, t))(ts)
        cn_x, cn_y, cedge_ok, chmin, chmax = _hull_edges(
            jnp.moveaxis(hulls_T[..., 0], 0, -1),    # (O, K, T)
            jnp.moveaxis(hulls_T[..., 1], 0, -1))

        # shared object-path segment data for the interaction screen
        path = objs["pred_xy"]                       # (O, P, 2)
        seg_a = path[:, :-1]                         # (O, S, 2)
        seg_v = path[:, 1:] - path[:, :-1]
        vv = jnp.maximum(jnp.sum(seg_v * seg_v, axis=-1), 1e-12)
        seg_len = jnp.sqrt(vv)
        arc0 = jnp.concatenate(
            [jnp.zeros((O, 1), f32), jnp.cumsum(seg_len, axis=1)],
            axis=1)[:, :-1]                          # (O, S)
        seg_ang = jnp.arctan2(seg_v[..., 1], seg_v[..., 0])

        # per-candidate state channels, time-major: (T, C)
        st = jnp.moveaxis(states, 0, -1)             # (T, 9, C)
        sx, sy, sh = st[:, V_X], st[:, V_Y], st[:, V_H]
        l_off = pp["length_veh"] / 2.0 - pp["dist_back_veh"]

        near_rad = (pp["radius_veh"] + objs["radius_hull"][None, :]
                    + v_T)                            # (T, O)

        def screens_at(_, inp):
            (cx, cy, ch, hx_t, hy_t, nx_t, ny_t, eok_t, hmin_t, hmax_t,
             pox_t, poy_t, nrad_t) = inp
            # collision screen: ego rect (anchored at the state position
            # like vehicle_hull) vs shared hulls; the l_off-shifted
            # center feeds only the `near` gate, as in coll_at
            hit = _rect_sat_hit(cx, cy, ch,
                                hx_t[..., None], hy_t[..., None],
                                nx_t[..., None], ny_t[..., None],
                                eok_t[..., None],
                                hmin_t[..., None], hmax_t[..., None], pp)
            ccx = cx + l_off * jnp.cos(ch)
            ccy = cy + l_off * jnp.sin(ch)
            dist_o = jnp.sqrt((pox_t[:, None] - ccx) ** 2
                              + (poy_t[:, None] - ccy) ** 2)  # (O, C)
            near = (dist_o <= nrad_t[:, None]) & objs["valid"][:, None]
            coll_t = jnp.any(hit & near, axis=0)      # (C,)

            # interaction screen: project ego pos on each object path
            pv_q = ((cx - seg_a[..., None, 0]) * seg_v[..., None, 0]
                    + (cy - seg_a[..., None, 1]) * seg_v[..., None, 1]) \
                / vv[..., None]                       # (O, S, C)
            qc = jnp.clip(pv_q, 0.0, 1.0)
            fx = seg_a[..., None, 0] + seg_v[..., None, 0] * qc
            fy = seg_a[..., None, 1] + seg_v[..., None, 1] * qc
            d2 = (cx - fx) ** 2 + (cy - fy) ** 2
            best = jnp.argmin(d2, axis=1)             # (O, C)
            sel = jax.nn.one_hot(best, S_SEG, axis=1, dtype=f32)
            pick = lambda a: jnp.sum(a * sel, axis=1)  # (O,S,C)->(O,C)
            pick_sh = lambda tab: jnp.sum(tab[..., None] * sel, axis=1)
            q_b = pick(pv_q)
            fx_b, fy_b = pick(fx), pick(fy)
            dist = jnp.sqrt(pick(d2))
            in_b = ~(((best == 0) & (q_b < 0.0))
                     | ((best == S_SEG - 1) & (q_b > 1.0)))
            arc = pick_sh(arc0) + jnp.sqrt(
                (fx_b - pick_sh(seg_a[..., 0])) ** 2
                + (fy_b - pick_sh(seg_a[..., 1])) ** 2)
            ang = pick_sh(seg_ang)
            # sign of the lateral offset (project_polyline semantics)
            ox, oy = fx_b - cx, fy_b - cy
            on = jnp.sqrt(ox ** 2 + oy ** 2)
            inv = 1.0 / jnp.maximum(on, 1e-12)
            sdx, sdy = jnp.cos(ang), jnp.sin(ang)
            sign_neg = (sdx * (-oy * inv) + sdy * (ox * inv)) <= 0.0
            dist = jnp.where(sign_neg, -dist, dist)
            dist = jnp.where(on < 1e-9, 0.0, dist)

            ok = in_b & objs["valid"][:, None] & (
                jnp.abs(dist) <= pp["radius_veh"]
                + objs["radius_hull"][:, None])

            # prediction time at the matched station
            dists_o = objs["pred_dists"]              # (O, P)
            i_st = jnp.clip(jnp.sum(
                (dists_o[..., None] <= arc[:, None]).astype(jnp.int32),
                axis=1) - 1, 0, P - 2)                # (O, C)
            oh_i = jax.nn.one_hot(i_st, P, axis=1, dtype=f32)
            oh_j = jax.nn.one_hot(i_st + 1, P, axis=1, dtype=f32)
            pk = lambda tab: (jnp.sum(tab[..., None] * oh_i, axis=1),
                              jnp.sum(tab[..., None] * oh_j, axis=1))
            d_i, d_j = pk(dists_o)
            a_st = jnp.clip((arc - d_i)
                            / jnp.maximum(d_j - d_i, 1e-9), 0.0, 1.0)
            t_i, t_j = pk(objs["pred_t"])
            tt = t_i * (1.0 - a_st) + t_j * a_st      # (O, C)

            # hull interpolated at tt (per candidate): 2-hot over P
            i_t = jnp.clip(jnp.sum(
                (objs["pred_t"][..., None] <= tt[:, None]).astype(
                    jnp.int32), axis=1) - 1, 0, P - 2)
            oha = jax.nn.one_hot(i_t, P, axis=1, dtype=f32)
            ohb = jax.nn.one_hot(i_t + 1, P, axis=1, dtype=f32)
            ta = jnp.sum(objs["pred_t"][..., None] * oha, axis=1)
            tb = jnp.sum(objs["pred_t"][..., None] * ohb, axis=1)
            aa = jnp.clip((tt - ta) / jnp.maximum(tb - ta, 1e-9),
                          0.0, 1.0)
            w = oha * (1.0 - aa[:, None]) + ohb * aa[:, None]  # (O,P,C)
            hpx = jnp.einsum("opc,opk->okc", w,
                             objs["hull_preds"][..., 0])
            hpy = jnp.einsum("opc,opk->okc", w,
                             objs["hull_preds"][..., 1])
            inx, iny, ieok, ihmin, ihmax = _hull_edges(hpx, hpy)
            ihit = _rect_sat_hit(cx, cy, ch, hpx, hpy, inx, iny, ieok,
                                 ihmin, ihmax, pp)
            oncoming = jnp.cos(ch - ang) < 0.0
            inter_t = jnp.sum(jnp.where(
                ok & ihit & oncoming,
                1.0 / (1.0 + jnp.abs(dist)), 0.0), axis=0)  # (C,)
            return None, (coll_t, inter_t)

        _, (colls, inter) = jax.lax.scan(
            screens_at, None,
            (sx, sy, sh,
             hulls_T[..., 0], hulls_T[..., 1],
             jnp.moveaxis(cn_x, -1, 0), jnp.moveaxis(cn_y, -1, 0),
             jnp.moveaxis(cedge_ok, -1, 0),
             jnp.moveaxis(chmin, -1, 0), jnp.moveaxis(chmax, -1, 0),
             pos_T[..., 0], pos_T[..., 1], near_rad))
        # colls, inter: (T, C)

        any_coll = jnp.any(colls, axis=0)             # (C,)
        first_coll = jnp.argmax(colls, axis=0)
        t_coll = ts[first_coll]
        invalid = any_coll & (t_coll < 3.0)
        cost_collision = jnp.where(any_coll, T * pp["dt"] - t_coll, 0.0)

        before = jnp.arange(T)[:, None] < jnp.where(any_coll,
                                                    first_coll, T)
        cost_interaction = jnp.sum(jnp.where(before, inter, 0.0), axis=0)

        # distance cost
        seg = jnp.sqrt(jnp.diff(sx, axis=0) ** 2
                       + jnp.diff(sy, axis=0) ** 2)
        cost_distance = 1000.0 - jnp.sum(seg, axis=0)

        # comfort costs
        cost = pp["w_l"] * (l_trg_global - l_trgs) ** 2
        min_dl = jnp.min(ref_states[:, :-1, R_DL], axis=1)
        min_dr = jnp.min(ref_states[:, :-1, R_DR], axis=1)
        cost += jnp.where(min_dl < pp["d_comf_lat"],
                          pp["w_lat_dist"] * (pp["d_comf_lat"] - min_dl)
                          / pp["d_comf_lat"], 0.0)
        cost += jnp.where(min_dr < pp["d_comf_lat"],
                          pp["w_lat_dist"] * (pp["d_comf_lat"] - min_dr)
                          / pp["d_comf_lat"], 0.0)
        cost += jnp.sum(pp["w_a"]
                        * jnp.minimum(0.0, states[:, :, V_A]) ** 2,
                        axis=1)

        # road-edge penalty (channel-restricted lookups: gather the 2
        # channels it reads, not all 7)
        s_ct = states[:, :, V_S]
        dl_rp = _ref_ch_lerp(ref_line, ref_step, s_ct, 5)     # (C, T)
        dr_rp = _ref_ch_lerp(ref_line, ref_step, s_ct, 6)
        margin = pp["width_veh"] / 2.0 * np.sqrt(2.0)
        edge = (jnp.sum(states[:, :, V_L] > dl_rp - margin, axis=1)
                + jnp.sum(states[:, :, V_L] < -dr_rp + margin,
                          axis=1)).astype(f32)

        # on collision the reference skips distance/comfort/edge costs
        cost_collision = cost_collision + jnp.where(any_coll, 0.0, edge)
        cost = jnp.where(any_coll, 0.0, cost)
        cost_distance = jnp.where(any_coll, 0.0, cost_distance)

        return dict(cost=cost, cost_distance=cost_distance,
                    cost_interaction=cost_interaction,
                    cost_collision=cost_collision,
                    invalid=invalid)

    S_SEG = P - 1

    @jax.jit
    def run(init_ref, init_con, l_trgs, d_stops, dt_replan, ref_line,
            ref_step, objs, pp, l_trg_global):
        """Roll out + evaluate all candidates.

        l_trgs: (C,), d_stops: (C,). Returns (ref_states (C,T,10),
        states (C,T,9), costs dict of (C,) arrays).
        """
        # the kernel runs in f32; host arrays may arrive as f64 under x64
        def _f32(v):
            v = jnp.asarray(v)
            return v.astype(f32) if jnp.issubdtype(
                v.dtype, jnp.floating) else v
        (init_ref, init_con, l_trgs, d_stops, dt_replan, ref_line,
         ref_step, l_trg_global) = (
            _f32(init_ref), _f32(init_con), _f32(l_trgs), _f32(d_stops),
            _f32(dt_replan), _f32(ref_line), _f32(ref_step),
            _f32(l_trg_global))
        objs = jax.tree.map(_f32, objs)
        pp = {k: _f32(v) for k, v in pp.items()}
        linestrip = ref_line[:, :2]

        def chunk(args):
            l_t, d_s = args
            refs, cons = rollout_lanes(
                init_ref, init_con, l_t, d_s, dt_replan, ref_line,
                ref_step, linestrip, objs, pp)
            costs = evaluate_lanes(refs, cons, l_t, objs, ref_line,
                                   ref_step, pp, l_trg_global)
            return refs, cons, costs

        # chunked dispatch: rollouts vmap per 1024-candidate chunk (the
        # scan state stays small), then the lanes-form evaluate screens
        # the whole chunk at once
        C = l_trgs.shape[0]
        if C <= 1024:
            return chunk((l_trgs, d_stops))
        n_pad = (-C) % 1024
        lt2 = jnp.concatenate(
            [l_trgs, jnp.broadcast_to(l_trgs[-1:], (n_pad,))])
        ds2 = jnp.concatenate(
            [d_stops, jnp.broadcast_to(d_stops[-1:], (n_pad,))])
        refs, cons, costs = jax.lax.map(
            chunk, (lt2.reshape(-1, 1024), ds2.reshape(-1, 1024)))
        unsplit = lambda a: a.reshape((-1,) + a.shape[2:])[:C]
        return (unsplit(refs), unsplit(cons),
                jax.tree.map(unsplit, costs))

    @jax.jit
    def run_rollout(init_ref, init_con, l_trgs, d_stops, dt_replan,
                    ref_line, ref_step, objs, pp):
        """Lanes rollout stage alone (tests compare it with rollout_ref)."""
        return rollout_lanes(init_ref, init_con, l_trgs, d_stops,
                             dt_replan, ref_line, ref_step,
                             ref_line[:, :2], objs, pp)

    @jax.jit
    def run_rollout_ref(init_ref, init_con, l_trgs, d_stops, dt_replan,
                        ref_line, ref_step, objs, pp):
        """Per-candidate vmap rollout: the reference oracle the lanes
        form is validated against (tests/test_idm_kernel.py)."""
        linestrip = ref_line[:, :2]
        return jax.vmap(lambda lt, ds: rollout(
            init_ref, init_con, lt, ds, dt_replan, ref_line, ref_step,
            linestrip, objs, pp))(l_trgs, d_stops)

    @jax.jit
    def run_evaluate_ref(ref_states, states, l_trgs, objs, ref_line,
                         ref_step, pp, l_trg_global):
        """Per-candidate vmap evaluate: the reference oracle the
        lanes form is validated against (tests/test_idm_kernel.py)."""
        return jax.vmap(lambda rs, cs, lt: evaluate(
            rs, cs, lt, objs, ref_line, ref_step, pp, l_trg_global))(
            ref_states, states, l_trgs)

    run.rollout = run_rollout
    run.rollout_ref = run_rollout_ref
    run.evaluate_ref = run_evaluate_ref
    run.evaluate = jax.jit(evaluate_lanes)
    return run
