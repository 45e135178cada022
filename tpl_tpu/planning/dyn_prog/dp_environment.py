"""
DP environment: the shared Frenet-grid world model for the DP planners.

JAX re-design of the reference's GPU environment (reference:
library/src/dyn_prog/env.cu, occupancy_renderer.cu): instead of rendering
swept prediction triangles through OpenGL/EGL into a bitmask texture and
sampling it back with CUDA, swept prediction ribbons are built host-side as
convex quads and rasterized *directly* into the dense (t, s, l) Frenet grid
by one jitted XLA program (point-in-dilated-convex-quad tests, vectorized
over all cells x quads). Distance maps are computed with cumulative scans
instead of sequential per-thread loops.

Occupancy cell values (env.cu:11-63): 0 = free, 1 = occupied (moving),
2 = off-road / grid boundary / zero-speed cell, 3 = stationary obstacle.

Divergence note: the reference dilates rasterized pixels with a circular
kernel (env.cu:25-43); here dilation is by euclidean distance to the quad's
supporting halfplanes, which over-approximates the dilation near convex
corners (strictly more conservative).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu import util
from tpl_tpu.ops import project
from tpl_tpu.ops.interp import lerp_xs


class DpEnvParams:
    """(reference: env.cuh:11-44 DynProgEnvParams)"""

    def __init__(self):
        self.t_min = 0.0
        self.t_max = 10.0
        self.l_min = -5.0
        self.l_max = 5.0
        self.s_min = 0.0
        self.s_max = 200.0

        self.ds_max = 36.0

        self.dir_min = -np.pi / 2
        self.dir_max = np.pi / 2

        self.dt = 1.0
        self.dt_start = 1.0

        self.t_steps = 10
        self.l_steps = 21
        self.s_steps = 201
        self.dir_steps = 21

        self.scale_objects = 1.0
        self.dilation = 2.0

    @property
    def l_step_size(self):
        return (self.l_max - self.l_min) / (self.l_steps - 1)

    @property
    def s_step_size(self):
        return (self.s_max - self.s_min) / (self.s_steps - 1)


class DpEnvGrid:
    """Device-resident environment grids."""

    def __init__(self, occ_map, dist_map_lon, ref_line, params):
        self.occ_map = occ_map            # (T, S, L) float32
        self.dist_map_lon = dist_map_lon  # (T, S, L, 2) float32
        self.ref_line = ref_line          # (N, 8) float32 device
        self.params = params


# ref line channel indices (x, y, heading, k, v_max, d_left, d_right, semantic)
RL_X, RL_Y, RL_H, RL_K, RL_V, RL_DL, RL_DR, RL_SEM = range(8)


@functools.partial(jax.jit, static_argnames=("t_steps", "s_steps", "l_steps"))
def _build_grids(ref_line, ref_step, quads, quad_tbit, quad_stat, quad_valid,
                 dilation, s_min, s_step, l_min, l_step,
                 t_steps, s_steps, l_steps):
    """Rasterize quads into the Frenet grid and build distance maps.

    quads: (Q, 4, 2) CCW convex quads in the ref line's cartesian frame
    quad_tbit: (Q,) int32 time-slice index of each quad
    quad_stat: (Q,) bool stationary flag
    """
    f32 = jnp.float32
    S, L, T = s_steps, l_steps, t_steps

    ss = s_min + jnp.arange(S, dtype=f32) * s_step
    ls = l_min + jnp.arange(L, dtype=f32) * l_step

    # ref line linear interp at cell s (reference: RefLine::lerp)
    n_ref = ref_line.shape[0]
    q = ss / ref_step
    i0 = jnp.clip(jnp.floor(q), 0, n_ref - 1).astype(jnp.int32)
    i1 = jnp.clip(jnp.ceil(q), 0, n_ref - 1).astype(jnp.int32)
    a = jnp.clip(q - i0, 0.0, 1.0)[:, None]
    rl = ref_line[i0] * (1.0 - a) + ref_line[i1] * a          # (S, 8)
    # nearest (texture point) channels for d_left/d_right/v_max/semantic
    i_n = jnp.clip(jnp.round(q), 0, n_ref - 1).astype(jnp.int32)
    rl_tex = ref_line[i_n]                                     # (S, 8)

    x_c = rl[:, RL_X][:, None] - ls[None, :] * jnp.sin(rl[:, RL_H])[:, None]
    y_c = rl[:, RL_Y][:, None] + ls[None, :] * jnp.cos(rl[:, RL_H])[:, None]
    cells = jnp.stack([x_c, y_c], axis=-1)                     # (S, L, 2)

    # point-in-dilated-quad: max over edge halfplane distances <= dilation
    e0 = quads                                                 # (Q, 4, 2)
    e1 = jnp.roll(quads, -1, axis=1)
    ev = e1 - e0                                               # (Q, 4, 2)
    elen = jnp.linalg.norm(ev, axis=-1)                        # (Q, 4)
    # outward normal for CCW polygons
    nrm = jnp.stack([ev[..., 1], -ev[..., 0]], axis=-1) / jnp.maximum(
        elen, 1e-9)[..., None]
    degenerate = elen < 1e-9

    # dist[s, l, q] = max_edges dot(cell - e0, nrm)
    rel = cells[:, :, None, None, :] - e0[None, None, :, :, :]  # (S,L,Q,4,2)
    d_edge = jnp.sum(rel * nrm[None, None], axis=-1)            # (S,L,Q,4)
    d_edge = jnp.where(degenerate[None, None], -jnp.inf, d_edge)
    d_quad = jnp.max(d_edge, axis=-1)                           # (S, L, Q)

    inside = (d_quad <= dilation) & quad_valid[None, None, :]

    t_ids = jnp.arange(T, dtype=jnp.int32)
    hit_t = inside[None] & (quad_tbit[None, None, None, :]
                            == t_ids[:, None, None, None])      # (T,S,L,Q)
    occ_bit = jnp.any(hit_t, axis=-1)                           # (T, S, L)
    stat_px = jnp.any(inside & quad_stat[None, None, :], axis=-1)  # (S, L)

    val = jnp.where(occ_bit, 1.0, 0.0)
    val = jnp.where(stat_px[None], 3.0, val)

    # off-road / boundary / zero-speed overrides (env.cu:52-61)
    off_road = ((ls[None, :] > rl_tex[:, RL_DL][:, None])
                | (ls[None, :] < -rl_tex[:, RL_DR][:, None]))
    edge_l = (jnp.arange(L) == 0) | (jnp.arange(L) == L - 1)
    zero_v = rl_tex[:, RL_V][:, None] < 0.1
    blocked = off_road | edge_l[None, :] | zero_v
    val = jnp.where(blocked[None], 2.0, val)

    # closeIntersections (env.cu:65-93): block full road width on occupied
    # intersection cells (semantic >= 0.5), inner l cells only
    semantic = jnp.round(rl_tex[:, RL_SEM]) >= 0.5              # (S,)
    inner = ~edge_l
    occupied_inner = jnp.any((val == 1.0) & inner[None, None, :], axis=-1)
    close = semantic[None, :] & occupied_inner                   # (T, S)
    val = jnp.where(close[:, :, None] & inner[None, None, :], 1.0, val)

    occ_map = val.astype(f32)

    # longitudinal distance maps (env.cu:95-129): channel 0 = distance to
    # next occupied cell ahead, channel 1 = behind; free tails accumulate
    # from 10000.
    occ_any = occ_map > 0.0
    s_idx = jnp.arange(S, dtype=f32)

    nxt = jnp.where(occ_any, s_idx[None, :, None], jnp.inf)
    next_occ = jax.lax.cummin(nxt, axis=1, reverse=True)        # (T, S, L)
    d_fwd = jnp.where(jnp.isfinite(next_occ),
                      (next_occ - s_idx[None, :, None]) * s_step,
                      10000.0 + (S - s_idx[None, :, None]) * s_step)

    prv = jnp.where(occ_any, s_idx[None, :, None], -jnp.inf)
    prev_occ = jax.lax.cummax(prv, axis=1)
    d_bwd = jnp.where(jnp.isfinite(prev_occ),
                      (s_idx[None, :, None] - prev_occ) * s_step,
                      10000.0 + (s_idx[None, :, None] + 1.0) * s_step)

    dist_map_lon = jnp.stack([d_fwd, d_bwd], axis=-1).astype(f32)

    return occ_map, dist_map_lon


@functools.partial(jax.jit, static_argnames=())
def _dist_map_path(occ_map, path_sl, s_min, s_step, l_min, l_step):
    """Distance to the next occupied cell along an arbitrary path.

    path_sl: (S, 2) frenet (s, l) of the path sampled at each grid s index
    (env.cu:131-158). Returns (T, S).
    """
    T, S, L = occ_map.shape
    idx_s = jnp.clip(((path_sl[:, 0] - s_min) / s_step).astype(jnp.int32),
                     0, S - 1)
    idx_l = jnp.clip(((path_sl[:, 1] - l_min) / l_step).astype(jnp.int32),
                     0, L - 1)
    occ = occ_map[:, idx_s, idx_l] > 0.0                        # (T, S)

    s_idx = jnp.arange(S, dtype=jnp.float32)
    nxt = jnp.where(occ, s_idx[None, :], jnp.inf)
    next_occ = jax.lax.cummin(nxt, axis=1, reverse=True)
    d = jnp.where(jnp.isfinite(next_occ),
                  (next_occ - s_idx[None, :]) * s_step,
                  10000.0 + (S - s_idx[None, :]) * s_step)
    return d


@functools.partial(jax.jit, static_argnames=("dir_steps", "ray_steps"))
def _dir_dist_map(occ_map, s_min, s_step, l_min, l_step, dir_min, dir_max,
                  ds_max, dir_steps, ray_steps):
    """Ray-marched directional distance field per time slice.

    (reference: env.cu:160-214 updateDirDistMap) Returns (T, S, L, D).
    """
    T, S, L = occ_map.shape
    f32 = jnp.float32
    angles = dir_min + jnp.arange(dir_steps, dtype=f32) \
        * (dir_max - dir_min) / (dir_steps - 1)
    step_size = jnp.minimum(s_step, l_step)
    ds = step_size * jnp.cos(angles)               # (D,)
    dl = step_size * jnp.sin(angles)

    ss = s_min + jnp.arange(S, dtype=f32) * s_step
    ls = l_min + jnp.arange(L, dtype=f32) * l_step

    i_steps = jnp.arange(ray_steps, dtype=f32)     # (R,)

    # sample positions: (S, L, D, R)
    s_ray = ss[:, None, None, None] + ds[None, None, :, None] \
        * i_steps[None, None, None, :]
    l_ray = ls[None, :, None, None] + dl[None, None, :, None] \
        * i_steps[None, None, None, :]

    is_f = (s_ray - s_min) / s_step
    il_f = (l_ray - l_min) / l_step
    out_of_grid = ((is_f <= 0.0) | (is_f >= S) | (il_f <= 0.0)
                   | (il_f >= L))
    is_i = jnp.clip(is_f, 0, S - 1).astype(jnp.int32)
    il_i = jnp.clip(il_f, 0, L - 1).astype(jnp.int32)

    def per_t(occ_t):
        occ_hit = occ_t[is_i, il_i] > 0.0          # (S, L, D, R)
        blocked = occ_hit | out_of_grid
        any_block = jnp.any(blocked, axis=-1)
        first = jnp.argmax(blocked, axis=-1).astype(f32)
        dist = jnp.where(any_block, first * step_size, 10000.0)
        return dist

    return jax.vmap(per_t)(occ_map)


def gen_prediction_quads(pred_states, hull, path, ts, station_step_size=5.0,
                         expansion_rate=0.0, sweep_length=0.5):
    """Swept prediction footprint as convex quads with time stamps.

    Host-side twin of the reference's triangle generator (reference:
    library/src/utils.cpp:576-692 genPredictionGeometry): the object's
    Frenet band [d_min, d_max] along its predicted map path, swept from
    s_mid - len/2 to s_mid + max(sweep_length, dt) * v + len/2, in
    station_step_size segments. Returns list of (quad (4, 2), t).
    """
    path = np.asarray(path, dtype=np.float64)
    if len(path) < 2:
        return []
    path_step = np.linalg.norm(path[1] - path[0])

    def get_path(s):
        a = s / path_step
        i_prev = int(np.clip(np.floor(a), 0, len(path) - 2))
        i_next = int(np.clip(np.ceil(a), 1, len(path) - 1))
        a = np.clip(a - i_prev, 0.0, 1.0)
        return path[i_prev] * (1.0 - a) + path[i_next] * a

    # approximate object shape as a box in the path's frenet frame
    s_min = np.inf
    s_max = -np.inf
    d_min = np.inf
    d_max = -np.inf
    for v in hull:
        proj = project(path, v)
        if proj.in_bounds:
            s_min = min(proj.arc_len, s_min)
            s_max = max(proj.arc_len, s_max)
            d_min = min(proj.distance, d_min)
            d_max = max(proj.distance, d_max)
    if not np.isfinite(s_min):
        return []

    # prediction state at ts[0]
    pt = pred_states[:, 0]

    def interp_pred(t):
        i = np.searchsorted(pt, t)
        i0 = int(np.clip(i - 1, 0, len(pt) - 1))
        i1 = int(np.clip(i, 0, len(pt) - 1))
        if i1 == i0:
            a = 0.0
        else:
            a = np.clip((t - pt[i0]) / max(pt[i1] - pt[i0], 1e-9), 0.0, 1.0)
        return pred_states[i0] * (1 - a) + pred_states[i1] * a

    pp0 = interp_pred(ts[0])
    proj0 = project(path, pp0[1:3])

    l = s_max - s_min
    s_mid = proj0.arc_len

    quads = []
    for t_idx in range(len(ts) - 1):
        t = ts[t_idx]
        dt = ts[t_idx + 1] - t
        pp = interp_pred(t)
        v = pp[4]

        sg = -1.0 if v < 0.0 else 1.0
        s_start = s_mid - sg * l * 0.5
        s_stop = s_mid + max(sweep_length, dt) * v + sg * l * 0.5
        steps = int(abs(s_stop - s_start) / station_step_size) + 1

        for i in range(steps):
            s = s_start + i * station_step_size * sg
            ds = sg * min(abs(s_stop - s), station_step_size)
            if abs(ds) < 1e-3:
                break
            p0 = get_path(s)
            p1 = get_path(s + ds)
            seg = (p1 - p0) * sg
            vl = np.linalg.norm(seg)
            if vl < 1e-3:
                break
            ortho = np.array([-seg[1], seg[0]]) / vl
            quad = np.array([
                p0 + ortho * d_min,
                p1 + ortho * d_min,
                p1 + ortho * d_max,
                p0 + ortho * d_max,
            ])
            quads.append((quad, t))

        l *= 1.0 + expansion_rate
        s_mid += dt * v

    return quads


def _make_ccw(quad):
    area = 0.0
    for i in range(4):
        x0, y0 = quad[i]
        x1, y1 = quad[(i + 1) % 4]
        area += x0 * y1 - x1 * y0
    if area < 0:
        return quad[::-1].copy()
    return quad


class DpEnvironment:
    """JAX DynProgEnvironment (reference: env.cu:281-513)."""

    MAX_QUADS = 192

    def __init__(self):
        self.params = DpEnvParams()
        self.ref_line = None        # host numpy (N, 8), offset-centered
        self.ref_step = 0.5
        self.true_rows = 0          # unpadded rows (see set_ref_line)
        self.grid = None            # DpEnvGrid (device arrays)
        self._quads = []            # list of (quad, t_idx, stationary)
        # f32 precision: UTM coordinates are offset-centered like the
        # reference's RefLine (utils.hpp:135-220)
        self.x_offset = 0.0
        self.y_offset = 0.0

    def reinit_buffers(self, params):
        self.params = params
        self._quads = []

    def set_ref_line(self, ref_line, step_size, true_rows=None):
        """ref_line: (N, >=9) array [x, y, heading, s, k, v, d_left,
        d_right, semantic] (dp_env.py layout).

        ``true_rows``: number of leading rows that carry real map
        geometry when the tail is synthetic padding (dp_env.py
        pack_ref_line pads to recompile-bucket lengths); the coverage
        check in :meth:`device_inputs` runs against this count so padding
        cannot silently substitute for a too-short map window."""
        rl = np.asarray(ref_line, dtype=np.float64)
        self.true_rows = len(rl) if true_rows is None else int(true_rows)
        self.x_offset = float(np.mean(rl[:, 0]))
        self.y_offset = float(np.mean(rl[:, 1]))
        out = np.zeros((len(rl), 8), dtype=np.float32)
        out[:, RL_X] = rl[:, 0] - self.x_offset
        out[:, RL_Y] = rl[:, 1] - self.y_offset
        out[:, RL_H] = rl[:, 2]
        out[:, RL_K] = rl[:, 4]
        out[:, RL_V] = rl[:, 5]
        out[:, RL_DL] = rl[:, 6]
        out[:, RL_DR] = rl[:, 7]
        out[:, RL_SEM] = rl[:, 8] if rl.shape[1] > 8 else 0.0
        self.ref_line = out
        self.ref_step = float(step_size)

    def t_index(self, t):
        """Time -> slice index (env.cu:233-236)."""
        p = self.params
        return np.where(t < p.dt_start, 0,
                        np.round((np.asarray(t) - p.dt_start) / p.dt) + 1
                        ).astype(np.int32)

    def insert_geometry(self, quads_with_t, stationary):
        """quads_with_t: list of (quad (4,2) cartesian, t)."""
        offset = np.array([self.x_offset, self.y_offset])
        for quad, t in quads_with_t:
            t_idx = int(self.t_index(t))
            self._quads.append((_make_ccw(np.asarray(quad) - offset), t_idx,
                                bool(stationary)))

    def device_inputs(self):
        """Host-side packing of all _build_grids inputs (so a caller can
        feed them into a larger fused program, see
        lat_lon_kernel.make_latlon_replan)."""
        p = self.params
        if self.ref_line is None:
            raise RuntimeError("set_ref_line before update")
        # coverage is checked against the TRUE (unpadded) window: padded
        # rows are fabricated straight-road continuation and must never
        # satisfy this invariant (see set_ref_line)
        if self.true_rows * self.ref_step < p.s_max:
            raise RuntimeError(
                f"refline length = {self.true_rows * self.ref_step}"
                f" < environment s_max = {p.s_max}")

        Q = self.MAX_QUADS
        quads = np.zeros((Q, 4, 2), dtype=np.float32)
        tbit = np.full(Q, -1, dtype=np.int32)
        stat = np.zeros(Q, dtype=bool)
        valid = np.zeros(Q, dtype=bool)
        for i, (quad, t_idx, stationary) in enumerate(self._quads[:Q]):
            quads[i] = quad
            tbit[i] = min(t_idx, p.t_steps - 1)
            stat[i] = stationary
            valid[i] = True
        return (jnp.asarray(self.ref_line), jnp.float32(self.ref_step),
                jnp.asarray(quads), jnp.asarray(tbit), jnp.asarray(stat),
                jnp.asarray(valid), jnp.float32(p.dilation),
                jnp.float32(p.s_min), jnp.float32(p.s_step_size),
                jnp.float32(p.l_min), jnp.float32(p.l_step_size))

    def adopt_grid(self, occ, dist_lon):
        """Install externally computed (device-resident) grids."""
        self.grid = DpEnvGrid(occ, dist_lon, jnp.asarray(self.ref_line),
                              self.params)
        return self.grid

    def update(self):
        p = self.params
        inputs = self.device_inputs()
        occ, dist_lon = _build_grids(*inputs, p.t_steps, p.s_steps,
                                     p.l_steps)
        self.grid = DpEnvGrid(occ, dist_lon, jnp.asarray(self.ref_line), p)
        return self.grid

    def update_dist_map_path(self, path_sl):
        """path_sl: (s_steps, 2) frenet path samples; returns (T, S)."""
        p = self.params
        return _dist_map_path(self.grid.occ_map,
                              jnp.asarray(path_sl, jnp.float32),
                              jnp.float32(p.s_min), jnp.float32(p.s_step_size),
                              jnp.float32(p.l_min), jnp.float32(p.l_step_size))

    def update_dir_dist_map(self, ray_steps=None):
        """Compute the directional distance field (T, S, L, D) and cache it
        on the grid."""
        p = self.params
        if ray_steps is None:
            ray_steps = int(p.ds_max / min(p.s_step_size, p.l_step_size))
        dd = _dir_dist_map(
            self.grid.occ_map,
            jnp.float32(p.s_min), jnp.float32(p.s_step_size),
            jnp.float32(p.l_min), jnp.float32(p.l_step_size),
            jnp.float32(p.dir_min), jnp.float32(p.dir_max),
            jnp.float32(p.ds_max), p.dir_steps, ray_steps)
        self.grid.dir_dist_map = dd
        return dd

    # --- debug getters (env.cu:452-513) ---

    def get_occ_map(self):
        return np.asarray(self.grid.occ_map)

    def get_dist_map_lon(self):
        return np.asarray(self.grid.dist_map_lon)

    def get_dist_map_dir(self, idx_t):
        return np.asarray(self.grid.dir_dist_map[idx_t])
