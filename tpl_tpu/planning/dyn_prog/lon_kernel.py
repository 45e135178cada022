"""
Longitudinal DP planner kernel: value iteration over the (s, v, a) grid
along a fixed path with jerk actions.

JAX re-design of the reference's CUDA kernels (reference:
library/src/dyn_prog/lon_planner.cu): per-thread node evaluations become
whole-grid vectorized evaluations; trilinear texture value lookups become
manual trilinear interpolation. The planner follows a path produced by the
lateral planner using the path distance map.

Path layout (PathState, common.cuh:100-113): columns
[x, y, s, l, k, v_max, distance]. Lon state layout: [t, s, v, a, j, cost,
constr] (lon_planner.cuh:55-67).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.planning.dyn_prog.dp_common import (
    lex_argmin, recip, unit_grid)

# lon state columns
LC_T, LC_S, LC_V, LC_A, LC_J, LC_COST, LC_CONSTR = range(7)

# path columns
PC_X, PC_Y, PC_S, PC_L, PC_K, PC_VMAX, PC_DIST = range(7)


class LonParams:
    """(reference: lon_planner.cuh:7-53)"""

    def __init__(self):
        self.s_min = 0.0
        self.s_max = 200.0
        self.v_min = 0.0
        self.v_max = 36.0
        self.a_min = -2.0
        self.a_max = 2.0
        self.j_min = -2.0
        self.j_max = 2.0

        self.t_steps = 10
        self.s_steps = 201
        self.v_steps = 37
        self.a_steps = 7

        self.dt_start = 1.0
        self.dt = 1.0

        self.time_gap = 1.5
        self.gap_min = 1.0

        self.w_progress = 1.0
        self.w_a = 0.5
        self.w_j = 0.5
        self.w_snap = 0.5
        self.w_safety_dist = 10.0

        self.path_step_size = 0.5
        self.path_steps = 200

        self.width_veh = 2.0
        self.length_veh = 6.0

    @property
    def s_step(self):
        return (self.s_max - self.s_min) / (self.s_steps - 1)

    @property
    def v_step(self):
        return (self.v_max - self.v_min) / (self.v_steps - 1)

    @property
    def a_step(self):
        return (self.a_max - self.a_min) / (self.a_steps - 1)

    def dynamic_dict(self):
        return {k: jnp.float32(getattr(self, k)) for k in LON_PP_KEYS}

    def packed(self):
        """All dynamic params as ONE f32 vector: a single host->device
        transfer per call instead of one per scalar leaf."""
        return np.array([getattr(self, k) for k in LON_PP_KEYS],
                        dtype=np.float32)


LON_PP_KEYS = ("s_min", "s_max", "v_min", "v_max", "a_min", "a_max",
               "j_min", "j_max", "dt_start", "dt", "time_gap", "gap_min",
               "w_progress", "w_a", "w_j", "w_snap", "w_safety_dist",
               "path_step_size", "width_veh", "length_veh")


def unpack_lon_pp(vec):
    """Expand a packed param vector back into the kernels' dict form
    (traced, inside jit)."""
    return {k: vec[i] for i, k in enumerate(LON_PP_KEYS)}


def lon_dynamics_np(state, j, dt):
    """(lon_planner.cu:240-251)"""
    res = np.array(state, dtype=np.float64).copy()
    res[LC_T] = state[LC_T] + dt
    res[LC_S] = max(state[LC_S],
                    state[LC_S] + state[LC_V] * dt
                    + 0.5 * state[LC_A] * dt * dt
                    + 1.0 / 6.0 * j * dt ** 3)
    res[LC_V] = max(0.0, state[LC_V] + state[LC_A] * dt + 0.5 * j * dt * dt)
    res[LC_A] = state[LC_A] + j * dt
    res[LC_J] = j
    return res


def lon_traj_state(traj, t):
    """(lon_planner.cu:253-261 LonTraj::state)"""
    return lon_traj_states(traj, np.asarray([t], dtype=np.float64))[0]


def lon_traj_states(traj, ts):
    """Vectorized :func:`lon_traj_state` over a time grid ts -> (N, 7)."""
    node_ts = traj[:, LC_T]
    idx = np.clip(np.searchsorted(node_ts, ts, side="right") - 1,
                  0, len(traj) - 1)
    base = traj[idx].astype(np.float64)
    t_rel = ts - base[:, LC_T]
    j = base[:, LC_J]
    out = base.copy()
    out[:, LC_T] = base[:, LC_T] + t_rel
    out[:, LC_S] = np.maximum(
        base[:, LC_S],
        base[:, LC_S] + base[:, LC_V] * t_rel
        + 0.5 * base[:, LC_A] * t_rel ** 2 + j * t_rel ** 3 / 6.0)
    out[:, LC_V] = np.maximum(
        0.0, base[:, LC_V] + base[:, LC_A] * t_rel + 0.5 * j * t_rel ** 2)
    out[:, LC_A] = base[:, LC_A] + j * t_rel
    out[:, LC_J] = j
    return out


def make_lon_solver(spec):
    """spec: t_steps, s_steps, v_steps, a_steps, path_steps (static)."""
    T = spec["t_steps"]
    S = spec["s_steps"]
    V = spec["v_steps"]
    A = spec["a_steps"]
    P = spec["path_steps"]
    NB = 9
    NF = 21

    f32 = jnp.float32

    def interp_path(path, dist, pp):
        """(common.cuh:115-139)"""
        a = dist / pp["path_step_size"]
        i0 = jnp.clip(jnp.floor(a), 0, P - 1).astype(jnp.int32)
        i1 = jnp.clip(jnp.ceil(a), 0, P - 1).astype(jnp.int32)
        al = (a - i0)[..., None]
        return path[i0] * (1.0 - al) + path[i1] * al

    def interp_dist_map_path(dist_path, t_idx, s, pp):
        """(env.cu:253-263): point lookup at rounded s index."""
        si = jnp.clip(jnp.round((s - pp["s_min"]) / (pp["s_max"] - pp["s_min"])
                                * (S - 1)), 0, S - 1).astype(jnp.int32)
        return dist_path[t_idx, si]

    def trilerp(nodes, s, v, a, pp):
        x = jnp.clip((s - pp["s_min"]) / (pp["s_max"] - pp["s_min"])
                     * (S - 1), 0.0, S - 1.0)
        y = jnp.clip((v - pp["v_min"]) / (pp["v_max"] - pp["v_min"])
                     * (V - 1), 0.0, V - 1.0)
        z = jnp.clip((a - pp["a_min"]) / (pp["a_max"] - pp["a_min"])
                     * (A - 1), 0.0, A - 1.0)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        z0 = jnp.floor(z).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, S - 1)
        y1 = jnp.minimum(y0 + 1, V - 1)
        z1 = jnp.minimum(z0 + 1, A - 1)
        ax = (x - x0)[..., None]
        ay = (y - y0)[..., None]
        az = (z - z0)[..., None]
        c00 = nodes[x0, y0, z0] * (1 - ax) + nodes[x1, y0, z0] * ax
        c10 = nodes[x0, y1, z0] * (1 - ax) + nodes[x1, y1, z0] * ax
        c01 = nodes[x0, y0, z1] * (1 - ax) + nodes[x1, y0, z1] * ax
        c11 = nodes[x0, y1, z1] * (1 - ax) + nodes[x1, y1, z1] * ax
        c0 = c00 * (1 - ay) + c10 * ay
        c1 = c01 * (1 - ay) + c11 * ay
        return c0 * (1 - az) + c1 * az

    def eval_grid(nodes_next, t, t_idx, dist_path, path, pp, dt, is_last):
        """Evaluate all (s, v, a) nodes for one backward slice."""
        ss = pp["s_min"] + jnp.arange(S, dtype=f32) \
            * ((pp["s_max"] - pp["s_min"]) * recip(S - 1))
        vs = pp["v_min"] + jnp.arange(V, dtype=f32) \
            * ((pp["v_max"] - pp["v_min"]) * recip(V - 1))
        aas = pp["a_min"] + jnp.arange(A, dtype=f32) \
            * ((pp["a_max"] - pp["a_min"]) * recip(A - 1))

        cps = interp_path(path, ss, pp)                       # (S, 7)
        v_max_s = cps[:, PC_VMAX]                             # (S,)
        s_dist = interp_dist_map_path(dist_path, t_idx, cps[:, PC_S], pp) \
            - pp["length_veh"] * 0.6                          # (S,)

        s_g = ss[:, None, None]
        v_g = vs[None, :, None]
        a_g = aas[None, None, :]

        state_cost = (pp["w_a"] * a_g ** 2
                      + pp["w_progress"] * jnp.abs(1000.0 - s_g)
                      + pp["w_safety_dist"] * jnp.maximum(
                          0.0, v_g * pp["time_gap"] + pp["gap_min"]
                          - s_dist[:, None, None]))
        state_constr = jnp.maximum(0.0, v_g - v_max_s[:, None, None])
        state_cost = jnp.broadcast_to(state_cost, (S, V, A))
        state_constr = jnp.broadcast_to(state_constr, (S, V, A))

        if is_last:
            node = jnp.stack([state_cost, jnp.zeros((S, V, A), f32),
                              jnp.zeros((S, V, A), f32),
                              jnp.zeros((S, V, A), f32)], axis=-1)
            return node

        js = pp["j_min"] + (pp["j_max"] - pp["j_min"]) \
            * unit_grid(NB)                                   # (NB,)

        # next states (lonDynamics)
        ds_change = (v_g[..., None] * dt + 0.5 * a_g[..., None] * dt * dt
                     + js[None, None, None, :] * dt ** 3 * recip(6))
        s_change = jnp.maximum(0.0, ds_change)                # (1,V,A,NB)->bc
        sn = s_g[..., None] + s_change                        # (S,V,A,NB)
        vn = jnp.maximum(0.0, v_g[..., None] + a_g[..., None] * dt
                         + 0.5 * js[None, None, None, :] * dt * dt)
        an = a_g[..., None] + js[None, None, None, :] * dt

        # Next-state trilinear value lookup with STRUCTURED indices
        # (same rework as lat_lon_kernel.py:306-340): the s-coordinate is
        # s + s_change where s_change and the (v, a) targets depend only
        # on the (v, a, j) combo — so per combo the s-axis lookup is a
        # uniform FRACTIONAL shift (two edge-clamped row shifts blended
        # by a constant weight) and only the (v, a) corners need real
        # lookups.  Equivalent to trilerp(nodes_next, sn, vn, an) but
        # without the 8-corner random gather over the full (S, V, A, NB)
        # tensor.
        NP = V * A * NB
        s_step_x = (pp["s_max"] - pp["s_min"]) * recip(S - 1)
        f_c = (s_change[0] / s_step_x).reshape(NP)            # (NP,)
        k_c = jnp.floor(f_c)
        ax_c = f_c - k_c                                      # (P,)
        k_c = k_c.astype(jnp.int32)

        y = jnp.clip((vn[0] - pp["v_min"]) / (pp["v_max"] - pp["v_min"])
                     * (V - 1), 0.0, V - 1.0).reshape(NP)
        an_b = jnp.broadcast_to(an, (1, V, A, NB))
        z = jnp.clip((an_b[0] - pp["a_min"]) / (pp["a_max"] - pp["a_min"])
                     * (A - 1), 0.0, A - 1.0).reshape(NP)
        y0 = jnp.floor(y).astype(jnp.int32)
        z0 = jnp.floor(z).astype(jnp.int32)
        y1 = jnp.minimum(y0 + 1, V - 1)
        z1 = jnp.minimum(z0 + 1, A - 1)
        wy = (y - y0)[:, None]                                # (NP, 1)
        wz = (z - z0)[:, None]

        # The (v, a)-corner bilerp: four row gathers from the (V*A, S*4)
        # table.  (A one-hot matrix product over the whole table did the
        # same work in 3.85 ms per solve against 1.15 ms on an H100 at
        # 10x201x37x20, and summed in an order each backend picks.)
        nodes_vas = jnp.transpose(nodes_next, (1, 2, 0, 3)) \
            .reshape(V * A, S * 4)
        row = lambda yi, zi: nodes_vas[yi * A + zi]           # (NP, S*4)
        B = ((row(y0, z0) * (1 - wy) + row(y1, z0) * wy) * (1 - wz)
             + (row(y0, z1) * (1 - wy) + row(y1, z1) * wy) * wz
             ).reshape(NP, S, 4)
        s_iota = jnp.arange(S, dtype=jnp.int32)[None, :]
        idx0 = jnp.clip(s_iota + k_c[:, None], 0, S - 1)
        idx1 = jnp.clip(s_iota + k_c[:, None] + 1, 0, S - 1)
        V0 = jnp.take_along_axis(B, idx0[:, :, None], axis=1)
        V1 = jnp.take_along_axis(B, idx1[:, :, None], axis=1)
        # upper-edge clamp: where s + f lands at/past the last row the
        # original trilerp used ax = 0 (x clipped before floor)
        ax_row = jnp.where(s_iota.astype(f32) + f_c[:, None] >= S - 1,
                           0.0, ax_c[:, None])                # (NP, S)
        nn = V0 * (1 - ax_row[..., None]) + V1 * ax_row[..., None]
        nn = nn.reshape(V, A, NB, S, 4).transpose(3, 0, 1, 2, 4)

        cost = state_cost[..., None] + nn[..., 0]
        constr = state_constr[..., None] + nn[..., 1]
        cost += pp["w_snap"] * (nn[..., 2] - js[None, None, None, :]) ** 2
        cost += pp["w_j"] * (js[None, None, None, :] * dt) ** 2

        v_max_n = interp_path(path[:, PC_VMAX:PC_VMAX + 1], sn.reshape(-1),
                              pp).reshape(sn.shape)
        constr += jnp.maximum(0.0, vn - v_max_n)
        constr += jnp.maximum(0.0, s_change - s_dist[:, None, None, None])
        constr += jnp.maximum(0.0, pp["a_min"] - an)
        constr += jnp.maximum(0.0, an - pp["a_max"])

        jidx, cmin, _, cost = lex_argmin(constr, cost)
        j_best = js[jidx]
        cost_best = jnp.take_along_axis(cost, jidx[..., None],
                                        axis=-1)[..., 0]

        node = jnp.stack([cost_best, cmin, j_best,
                          jnp.zeros((S, V, A), f32)], axis=-1)
        return node

    def eval_single(tp, nodes_next, t_idx, dist_path, path, pp, dt,
                    choose_action, n_actions):
        """Single-state node evaluation (evalNode, lon_planner.cu:71-177)."""
        s, v, a = tp[LC_S], tp[LC_V], tp[LC_A]
        cps = interp_path(path, s, pp)
        v_max = cps[PC_VMAX]
        s_dist = interp_dist_map_path(dist_path, t_idx, cps[PC_S], pp) \
            - pp["length_veh"] * 0.6

        state_cost = (pp["w_a"] * a ** 2
                      + pp["w_progress"] * jnp.abs(1000.0 - s)
                      + pp["w_safety_dist"] * jnp.maximum(
                          0.0, v * pp["time_gap"] + pp["gap_min"] - s_dist))
        state_constr = jnp.maximum(0.0, v - v_max)

        is_last = jnp.round(tp[LC_T] / pp["dt"]) == T - 1

        if choose_action:
            js = pp["j_min"] + (pp["j_max"] - pp["j_min"]) \
                * unit_grid(n_actions)
        else:
            js = tp[LC_J][None]

        ds_change = v * dt + 0.5 * a * dt * dt + js * dt ** 3 * recip(6)
        s_change = jnp.maximum(0.0, ds_change)
        sn = s + s_change
        vn = jnp.maximum(0.0, v + a * dt + 0.5 * js * dt * dt)
        an = a + js * dt

        nn = trilerp(nodes_next, sn, vn, an, pp)
        cost = state_cost + nn[..., 0]
        constr = state_constr + nn[..., 1]
        cost += pp["w_snap"] * (nn[..., 2] - js) ** 2
        cost += pp["w_j"] * (js * dt) ** 2
        v_max_n = interp_path(path, sn, pp)[..., PC_VMAX]
        constr += jnp.maximum(0.0, vn - v_max_n)
        constr += jnp.maximum(0.0, s_change - s_dist)
        constr += jnp.maximum(0.0, pp["a_min"] - an)
        constr += jnp.maximum(0.0, an - pp["a_max"])

        jidx, cmin, _, cost = lex_argmin(constr, cost)
        j_best = js[jidx]
        cost_best = cost[jidx]

        tp = tp.at[LC_J].set(jnp.where(is_last, tp[LC_J], j_best))
        tp = tp.at[LC_COST].set(jnp.where(is_last, state_cost, cost_best))
        tp = tp.at[LC_CONSTR].set(jnp.where(is_last, tp[LC_CONSTR], cmin))
        return tp

    def backward_node(nodes_next, i, dist_path, path, pp):
        """Backward slice ``i`` from the next slice's nodes."""
        t = pp["dt_start"] + (i.astype(f32) - 1.0) * pp["dt"]
        t_idx = jnp.clip(i, 0, T - 1).astype(jnp.int32)
        return eval_grid(nodes_next, t, t_idx, dist_path, path, pp,
                         pp["dt"], False)

    @jax.jit
    def solve(dist_path, path, pp, x0):
        """dist_path: (T, S); path: (P, 7); x0: (7,) lon state.
        pp: param dict or packed f32 vector (LonParams.packed())."""
        if not isinstance(pp, dict):
            pp = unpack_lon_pp(pp)

        nodes_final = eval_grid(
            jnp.zeros((S, V, A, 4), f32),
            pp["dt_start"] + f32(T - 2) * pp["dt"], T - 1, dist_path, path,
            pp, pp["dt"], True)

        def bwd(carry, i):
            node = backward_node(carry, i, dist_path, path, pp)
            return node, node

        idxs = jnp.arange(T - 2, 0, -1)
        _, nodes_seq = jax.lax.scan(bwd, nodes_final, idxs)
        nodes = jnp.concatenate([
            jnp.zeros((1, S, V, A, 4), f32),
            nodes_seq[::-1],
            nodes_final[None]], axis=0)

        # forward
        def fwd(tp, i):
            dt_i = jnp.where(i == 0, pp["dt_start"], pp["dt"])
            t_idx = jnp.where(tp[LC_T] < pp["dt_start"], 0,
                              jnp.round((tp[LC_T] - pp["dt_start"])
                                        / pp["dt"]) + 1).astype(jnp.int32)
            t_idx = jnp.clip(t_idx, 0, T - 1)
            nodes_next = nodes[jnp.minimum(i + 1, T - 1)]
            tp_out = eval_single(tp, nodes_next, t_idx, dist_path, path, pp,
                                 dt_i, True, NF)
            # next state
            j = tp_out[LC_J]
            tn = jnp.zeros_like(tp_out)
            tn = tn.at[LC_T].set(tp_out[LC_T] + dt_i)
            tn = tn.at[LC_S].set(jnp.maximum(
                tp_out[LC_S],
                tp_out[LC_S] + tp_out[LC_V] * dt_i
                + 0.5 * tp_out[LC_A] * dt_i ** 2 + j * dt_i ** 3 * recip(6)))
            tn = tn.at[LC_V].set(jnp.maximum(
                0.0, tp_out[LC_V] + tp_out[LC_A] * dt_i
                + 0.5 * j * dt_i ** 2))
            tn = tn.at[LC_A].set(tp_out[LC_A] + j * dt_i)
            tn = tn.at[LC_J].set(j)
            return tn, tp_out

        _, traj = jax.lax.scan(fwd, x0.astype(f32), jnp.arange(T))
        return nodes, traj

    @jax.jit
    def reeval(dist_path, path, pp, traj, nodes):
        """Re-evaluate a stored trajectory (lonReevalNode)."""
        if not isinstance(pp, dict):
            pp = unpack_lon_pp(pp)

        def body(carry, inp):
            i, tp = inp
            dt_i = jnp.where(i == 0, pp["dt_start"], pp["dt"])
            t_idx = jnp.where(tp[LC_T] < pp["dt_start"], 0,
                              jnp.round((tp[LC_T] - pp["dt_start"])
                                        / pp["dt"]) + 1).astype(jnp.int32)
            t_idx = jnp.clip(t_idx, 0, T - 1)
            nodes_next = nodes[jnp.minimum(i + 1, T - 1)]
            tp_out = eval_single(tp, nodes_next, t_idx, dist_path, path, pp,
                                 dt_i, False, 1)
            return carry, tp_out

        _, out = jax.lax.scan(body, 0,
                              (jnp.arange(len(traj)), traj.astype(f32)))
        return out

    @jax.jit
    def backward_step(nodes_next, i, dist_path, path, pp):
        """One backward slice as the solve scans it (see
        lat_lon_kernel's backward_step for why it is exposed)."""
        if not isinstance(pp, dict):
            pp = unpack_lon_pp(pp)
        return backward_node(nodes_next, i, dist_path, path, pp)

    solve.backward_step = backward_step
    return solve, reeval
