"""
Graph/polynomial DP planner kernel: a precomputed DAG of (t, ds, l)
maneuver nodes whose edges are evaluated by fitting quartic-longitudinal +
quintic-lateral polynomial connections and integrating jerk / velocity /
lateral / occupancy costs, followed by backward cost propagation and a
backtrack.

JAX re-design of the reference's CUDA planner (reference:
library/src/dyn_prog/poly_planner.cu): one thread per edge becomes one
vectorized evaluation over the whole edge tensor per evaluation step;
the cost relaxation becomes a segment-min over edges grouped by start
node. Graph construction (with rate-feasibility pruning) is vectorized
numpy on the host, cached per (ds, l) start index.

Note: the reference's python driver for this planner is not registered and
references missing APIs (snapshot WIP); this implementation keeps the
kernel semantics and provides a working driver.
"""

import numpy as np
import jax
import jax.numpy as jnp


# point fields: t, s, ds, dds, l, dl, ddl, cost
PP_T, PP_S, PP_DS, PP_DDS, PP_L, PP_DL, PP_DDL, PP_COST = range(8)


class DpPolyParams:
    """(reference: poly_planner.cuh:8-52)"""

    def __init__(self):
        self.eval_steps = 2

        self.t_steps = 10
        self.s_steps = 201
        self.ds_steps = 15
        self.l_steps = 21

        self.s_min = 0.0
        self.s_max = 200.0
        self.ds_min = 0.0
        self.ds_max = 36.0
        self.dds_min = -3.0
        self.dds_max = 3.0
        self.l_min = -5.0
        self.l_max = 5.0
        self.dl_min = -2.0
        self.dl_max = 2.0
        self.dt = 1.0
        self.dt_start = 1.0
        self.dt_cart = 0.1

        self.a_total_max = 3.0
        self.a_lat_abs_max = 3.0

        self.w_v_diff = 1.0
        self.w_l = 1.0
        self.w_j = 1.0

        self.width_veh = 0.0
        self.length_veh = 0.0

    @property
    def ds_step_size(self):
        return (self.ds_max - self.ds_min) / (self.ds_steps - 1)

    @property
    def l_step_size(self):
        return (self.l_max - self.l_min) / (self.l_steps - 1)

    def dynamic_dict(self):
        keys = ("s_min", "s_max", "ds_min", "ds_max", "l_min", "l_max",
                "dt", "dt_start", "a_total_max", "a_lat_abs_max",
                "w_v_diff", "w_l", "w_j", "width_veh", "length_veh")
        return {k: jnp.float32(getattr(self, k)) for k in keys}


def build_eval_graph(params, idx_ds_start, idx_l_start, max_edges=400_000):
    """Vectorized DAG construction with rate-feasibility pruning.

    (reference: poly_planner.cu:237-302 buildEvalGraph). Returns per step:
    node_specs (N, 3) [t, ds, l], edge_start_idx (E,) int32. Step k+1's
    nodes are step k's edges (one end node per edge, as in the reference).
    """
    p = params
    ds_vals = p.ds_min + np.arange(p.ds_steps) * p.ds_step_size
    l_vals = p.l_min + np.arange(p.l_steps) * p.l_step_size
    t_vals = np.arange(p.t_steps) * p.dt

    start = np.array([[0.0,
                       p.ds_min + idx_ds_start * p.ds_step_size,
                       p.l_min + idx_l_start * p.l_step_size]])

    node_steps = [start]
    edge_steps = []

    for _ in range(p.eval_steps):
        nodes = node_steps[-1]                    # (N, 3) [t, ds, l]
        # candidate ends: all (t_end > t_start, ds_end, l_end)
        te = t_vals[None, :, None, None]          # (1, T, 1, 1)
        de = ds_vals[None, None, :, None]
        le = l_vals[None, None, None, :]

        t0 = nodes[:, 0][:, None, None, None]
        d0 = nodes[:, 1][:, None, None, None]
        l0 = nodes[:, 2][:, None, None, None]

        tc = te - t0
        dsc = de - d0
        lc = le - l0
        feasible = ((tc > 1e-6)
                    & (dsc >= p.dds_min * tc) & (dsc <= p.dds_max * tc)
                    & (lc >= p.dl_min * tc) & (lc <= p.dl_max * tc))

        idx = np.argwhere(feasible)               # (E, 4)
        if len(idx) > max_edges:
            idx = idx[:max_edges]

        starts = idx[:, 0].astype(np.int32)
        ends = np.column_stack([
            t_vals[idx[:, 1]], ds_vals[idx[:, 2]], l_vals[idx[:, 3]]])

        edge_steps.append(starts)
        node_steps.append(ends)

    return node_steps, edge_steps


def make_edge_eval(n_int_steps, t_steps_env, s_steps_env, l_steps_env,
                   dir_steps_env):
    """Jitted edge evaluation for one evaluation step.

    (reference: poly_planner.cu:11-108 evalEdge)
    """
    f32 = jnp.float32
    R = n_int_steps

    def dir_dist_lookup(dir_dist, env_pp, t, s, l):
        """interpDirDistMap at dir = 0 (env.cu:265-276)."""
        t_idx = jnp.where(t < env_pp["dt_start"], 0.0,
                          jnp.round((t - env_pp["dt_start"])
                                    / env_pp["dt"]) + 1.0)
        ti = jnp.clip(t_idx, 0, t_steps_env - 1).astype(jnp.int32)
        si = jnp.clip(jnp.round(
            (s - env_pp["s_min"]) / (env_pp["s_max"] - env_pp["s_min"])
            * (s_steps_env - 1)), 0, s_steps_env - 1).astype(jnp.int32)
        li = jnp.clip(jnp.round(
            (l - env_pp["l_min"]) / (env_pp["l_max"] - env_pp["l_min"])
            * (l_steps_env - 1)), 0, l_steps_env - 1).astype(jnp.int32)
        di = jnp.clip(jnp.round(
            (0.0 - env_pp["dir_min"])
            / (env_pp["dir_max"] - env_pp["dir_min"])
            * (dir_steps_env - 1)), 0, dir_steps_env - 1).astype(jnp.int32)
        return dir_dist[ti, si, li, di]

    def ref_v_max(ref_line, ref_step, s):
        n = ref_line.shape[0]
        q = s / ref_step
        i0 = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
        i1 = jnp.clip(jnp.ceil(q), 0, n - 1).astype(jnp.int32)
        a = jnp.clip(q - i0, 0.0, 1.0)
        return ref_line[i0, 4] * (1.0 - a) + ref_line[i1, 4] * a

    def quartic_coeffs(t0, s0, ds0, dds0, t1, ds1):
        """PolyQuartic(t0, s0, ds0, dds0, t1, ds1, 0) coefficients in
        normalized u = (t - t0) / d."""
        d = t1 - t0
        b = jnp.stack([s0, ds0 * d, dds0 * d * d, ds1 * d,
                       jnp.zeros_like(s0)], axis=-1)
        from tpl_tpu.ops.splines import _M4_INV
        return b @ jnp.asarray(_M4_INV, f32).T, d

    def quintic_coeffs(t0, l0, dl0, ddl0, t1, l1):
        from tpl_tpu.ops.splines import _HERMITE_INV
        d = t1 - t0
        z = jnp.zeros_like(l0)
        b = jnp.stack([l0, dl0 * d, ddl0 * d * d, l1, z, z], axis=-1)
        return b @ jnp.asarray(_HERMITE_INV[5], f32).T, d

    def poly_eval(c, u, deriv, order):
        acc = 0.0
        for k in range(order, deriv - 1, -1):
            fac = float(np.prod(np.arange(k - deriv + 1, k + 1)))
            acc = acc * u + c[..., k] * fac
        return acc

    @jax.jit
    def eval_edges(start_pts, edge_starts, end_specs, is_last_step,
                   t_horizon, dir_dist, ref_line, ref_step, pp, env_pp):
        """start_pts: (Ns, 8); edge_starts: (E,) int32; end_specs: (E, 3)
        [t_end, ds_end, l_end]. Returns end_pts (E, 8) with cost."""
        # the kernel runs in f32; host arrays may arrive as f64 under x64
        def _f32(v):
            v = jnp.asarray(v)
            return v.astype(f32) if jnp.issubdtype(
                v.dtype, jnp.floating) else v
        start_pts, end_specs, t_horizon, dir_dist, ref_line, ref_step = (
            _f32(start_pts), _f32(end_specs), _f32(t_horizon),
            _f32(dir_dist), _f32(ref_line), _f32(ref_step))
        pp = {k: _f32(v) for k, v in pp.items()}
        env_pp = {k: _f32(v) for k, v in env_pp.items()}
        sp = start_pts[edge_starts]               # (E, 8)
        t0 = sp[:, PP_T]
        te = end_specs[:, 0]
        dse = end_specs[:, 1]
        le = end_specs[:, 2]

        c_lon, d_lon = quartic_coeffs(t0, sp[:, PP_S], sp[:, PP_DS],
                                      sp[:, PP_DDS], te, dse)
        c_lat, d_lat = quintic_coeffs(t0, sp[:, PP_L], sp[:, PP_DL],
                                      sp[:, PP_DDL], te, le)

        dt_step = 0.25
        ts = t0[:, None] + jnp.arange(R, dtype=f32)[None, :] * dt_step

        # coefficients broadcast over the integration axis
        cl_lon = c_lon[:, None, :]
        cl_lat = c_lat[:, None, :]

        # jerk costs integrated up to t_end
        u_lon = jnp.clip((ts - t0[:, None]) / d_lon[:, None], 0.0, 1.0)
        u_lat = jnp.clip((ts - t0[:, None]) / d_lat[:, None], 0.0, 1.0)
        in_poly = ts <= te[:, None]
        jerk_lon = poly_eval(cl_lon, u_lon, 3, 4) / d_lon[:, None] ** 3
        jerk_lat = poly_eval(cl_lat, u_lat, 3, 5) / d_lat[:, None] ** 3
        cost = pp["w_j"] * jnp.sum(
            jnp.where(in_poly, jerk_lon ** 2, 0.0), axis=-1)
        cost += pp["w_j"] * jnp.sum(
            jnp.where(in_poly, jerk_lat ** 2, 0.0), axis=-1)

        cost += pp["w_l"] * jnp.abs(0.0 - le)

        # rollout costs up to t_end (or the horizon on the last step)
        t_end_eval = jnp.where(is_last_step, t_horizon, te)
        active = ts <= t_end_eval[:, None]

        ds_t = jnp.where(in_poly,
                         poly_eval(cl_lon, u_lon, 1, 4) / d_lon[:, None],
                         (poly_eval(cl_lon, jnp.ones_like(u_lon), 1, 4)
                          / d_lon[:, None]))
        s_poly = poly_eval(cl_lon, u_lon, 0, 4)
        s_end = poly_eval(cl_lon, jnp.ones_like(u_lon), 0, 4)
        ds_end_v = poly_eval(cl_lon, jnp.ones_like(u_lon), 1, 4) \
            / d_lon[:, None]
        s_t = jnp.where(in_poly, s_poly,
                        s_end + (ts - te[:, None]) * ds_end_v)
        l_t = jnp.where(in_poly, poly_eval(cl_lat, u_lat, 0, 5),
                        poly_eval(cl_lat, jnp.ones_like(u_lat), 0, 5))

        v_max = ref_v_max(ref_line, ref_step, s_t)
        step_cost = pp["w_v_diff"] * jnp.abs(100.0 - ds_t)
        step_cost += 100.0 * jnp.maximum(0.0, ds_t - v_max)

        d_front = dir_dist_lookup(dir_dist, env_pp, ts, s_t, l_t)
        d_safety = d_front - pp["length_veh"] * 0.5 - 1.0 - ds_t * 1.0
        step_cost += jnp.where(ds_t * dt_step > d_safety,
                               100.0 * (ds_t * dt_step - d_safety), 0.0)

        cost += jnp.sum(jnp.where(active, step_cost, 0.0), axis=-1)

        # end point
        end = jnp.zeros((sp.shape[0], 8), f32)
        end = end.at[:, PP_T].set(te)
        end = end.at[:, PP_S].set(
            poly_eval(c_lon, jnp.ones_like(te), 0, 4))
        end = end.at[:, PP_DS].set(dse)
        end = end.at[:, PP_L].set(le)
        end = end.at[:, PP_COST].set(cost)
        return end

    return eval_edges


def propagate_and_backtrack(node_steps_pts, edge_steps, n_start_nodes):
    """Host-side cost relaxation + backtrack over the small DAG arrays.

    (reference: poly_planner.cu:110-155 propagateCost + copyTrajectory)
    """
    # backward relaxation: node cost += min over outgoing edge end costs
    best_edge = []
    for k in range(len(edge_steps) - 1, -1, -1):
        starts = edge_steps[k]                    # (E,) start node idx
        end_pts = node_steps_pts[k + 1]           # (E, 8), cost filled
        n_nodes = len(node_steps_pts[k])
        costs = end_pts[:, PP_COST]
        order = np.argsort(starts, kind="stable")
        sorted_starts = starts[order]
        sorted_costs = costs[order]
        bmin = np.full(n_nodes, np.inf)
        bidx = np.zeros(n_nodes, np.int64)
        # segmented argmin over edges grouped by start node
        boundaries = np.searchsorted(sorted_starts, np.arange(n_nodes))
        boundaries = np.append(boundaries, len(sorted_starts))
        for i in range(n_nodes):
            lo, hi = boundaries[i], boundaries[i + 1]
            if hi > lo:
                j = lo + np.argmin(sorted_costs[lo:hi])
                bmin[i] = sorted_costs[j]
                bidx[i] = order[j]
        # nodes without outgoing edges become infinitely costly, exactly
        # like the reference's min over an empty edge range
        # (poly_planner.cu:110-137)
        node_steps_pts[k][:, PP_COST] += bmin
        best_edge.insert(0, bidx)

    # backtrack
    traj = [node_steps_pts[0][0]]
    idx = 0
    for k in range(len(edge_steps)):
        nxt = best_edge[k][idx]
        traj.append(node_steps_pts[k + 1][nxt])
        idx = nxt
    return np.stack(traj)


class DpPolyPlannerKernel:
    """Stateful wrapper caching eval graphs per (ds, l) start index."""

    def __init__(self):
        self.params = DpPolyParams()
        self._graphs = {}
        self._eval = None
        self._eval_spec = None

    def reinit_buffers(self, params):
        if (params.eval_steps != self.params.eval_steps
                or params.t_steps != self.params.t_steps
                or params.ds_steps != self.params.ds_steps
                or params.l_steps != self.params.l_steps):
            self._graphs = {}
        self.params = params

    def update(self, init_state, env):
        """init_state: (8,) point; env: DpEnvironment with dir_dist_map.
        Returns (eval_steps + 1, 8) trajectory."""
        p = self.params
        ep = env.params

        idx_ds = int(round((init_state[PP_DS] - p.ds_min)
                           / p.ds_step_size))
        idx_ds = max(0, min(p.ds_steps - 1, idx_ds))
        idx_l = int(round((init_state[PP_L] - p.l_min) / p.l_step_size))
        idx_l = max(0, min(p.l_steps - 1, idx_l))

        key = (idx_ds, idx_l)
        if key not in self._graphs:
            self._graphs[key] = build_eval_graph(p, idx_ds, idx_l)
        node_steps, edge_steps = self._graphs[key]

        n_int = int(np.ceil((p.t_steps - 1) * p.dt / 0.25)) + 1
        spec = (n_int, ep.t_steps, ep.s_steps, ep.l_steps, ep.dir_steps)
        if self._eval_spec != spec:
            self._eval = make_edge_eval(*spec)
            self._eval_spec = spec

        if getattr(env.grid, "dir_dist_map", None) is None:
            env.update_dir_dist_map()

        env_pp = {
            "dt_start": jnp.float32(ep.dt_start),
            "dt": jnp.float32(ep.dt),
            "s_min": jnp.float32(ep.s_min), "s_max": jnp.float32(ep.s_max),
            "l_min": jnp.float32(ep.l_min), "l_max": jnp.float32(ep.l_max),
            "dir_min": jnp.float32(ep.dir_min),
            "dir_max": jnp.float32(ep.dir_max)}
        pp = p.dynamic_dict()
        t_horizon = (p.t_steps - 1) * p.dt

        # forward edge evaluation
        pts0 = np.zeros((1, 8), np.float32)
        pts0[0] = init_state
        node_pts = [pts0]
        for k, (starts, ends) in enumerate(
                zip(edge_steps, node_steps[1:])):
            is_last = k == len(edge_steps) - 1
            end_pts = self._eval(
                jnp.asarray(node_pts[k]), jnp.asarray(starts),
                jnp.asarray(ends, dtype=jnp.float32),
                jnp.asarray(np.full(len(starts), is_last)),
                jnp.float32(t_horizon),
                env.grid.dir_dist_map, env.grid.ref_line,
                jnp.float32(env.ref_step), pp, env_pp)
            node_pts.append(np.asarray(end_pts, np.float64))

        node_pts = [np.asarray(x, np.float64) for x in node_pts]
        return propagate_and_backtrack(node_pts, edge_steps, 1)
