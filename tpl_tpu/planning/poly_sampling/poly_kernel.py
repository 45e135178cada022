"""
Device kernel for the Frenet polynomial sampling planner.

One jitted program evaluates the whole Werling candidate grid: quintic
lateral x quartic longitudinal coefficient solves (constant-matrix
products), polynomial evaluation over the (C, N) candidate x
step grid, jerk/time/deviation costs, constraint penalties, a dense
batched SAT collision screen against padded obstacle hulls, and the
device-side argmin + gather of the winning candidate — so one dispatch
returns just the (N,)-sized best trajectory.

JAX counterpart of the reference's per-candidate C++ loops
(reference: library/src/poly_sampling.cpp:37-258).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.ops.splines import PolyQuintic, PolyQuartic
from tpl_tpu.ops.interp import short_angle_dist, lerp_xs

PENALTY = 10.0e6

# params shipped to the device as ONE packed f32 vector: each jitted-arg
# leaf is its own host->device transfer
PP_KEYS = ("k_j", "k_t", "trg_d", "k_d", "k_v", "k_lat", "k_lon",
           "k_overtake_right", "a_max", "k_max",
           "rear_axis_to_rear", "rear_axis_to_front", "width_ego")


def pack_pp(pp):
    return np.array([getattr(pp, k) for k in PP_KEYS], np.float32)


def _sat_separated_on(axes, pts_a, pts_b):
    """True where some axis in ``axes`` separates pts_a from pts_b.

    axes: (..., A, 2); pts_a: (..., Ka, 2); pts_b: (..., Kb, 2);
    broadcasting over leading dims. Zero axes (from padded vertices)
    never separate.
    """
    pa = jnp.einsum("...ka,...ja->...kj", pts_a, axes)   # (..., Ka, A)
    pb = jnp.einsum("...ka,...ja->...kj", pts_b, axes)
    return jnp.any((pa.max(-2) < pb.min(-2)) | (pb.max(-2) < pa.min(-2)),
                   axis=-1)


def _edges_normals(pts):
    e = jnp.roll(pts, -1, axis=-2) - pts
    return jnp.stack([-e[..., 1], e[..., 0]], axis=-1)


def hulls_intersect(hulls_a, hulls_b):
    """Batched convex SAT: broadcastable (..., Ka, 2) x (..., Kb, 2) ->
    (...,) bool. Padded (repeated) vertices are harmless: their zero
    edge normals cannot act as separating axes."""
    sep = (_sat_separated_on(_edges_normals(hulls_a), hulls_a, hulls_b)
           | _sat_separated_on(_edges_normals(hulls_b), hulls_a, hulls_b))
    return ~sep


@functools.lru_cache(maxsize=8)
def make_poly_sampling_kernel(n_cand, n_steps, n_path, n_obs, n_hull):
    """Jitted candidate-grid evaluation for static sizes.

    Returns run(start (6,), di (C,), Ti (C,), tv (C,), ts (N,),
    path (n_path, 6), obs_hulls (O, K, 2), obs_valid (O,), pp dict)
    -> dict of (N,) best-candidate arrays + scalar cost.
    """

    f32 = jnp.float32

    @jax.jit
    def run(start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp):
        start, di, Ti, tv, ts, path, obs_hulls = (
            jnp.asarray(a, f32)
            for a in (start, di, Ti, tv, ts, path, obs_hulls))
        if isinstance(pp, dict):
            pp = {k: jnp.asarray(v, f32) for k, v in pp.items()}
        else:
            vec = jnp.asarray(pp, f32)
            pp = {k: vec[i] for i, k in enumerate(PP_KEYS)}
        d0, dd0, ddd0, s0, sd0, sdd0 = (start[i] for i in range(6))

        C = n_cand
        zeros = jnp.zeros(C, f32)
        lat = PolyQuintic(zeros, jnp.full(C, d0), jnp.full(C, dd0),
                          jnp.full(C, ddd0), Ti, di, zeros, zeros)
        lon = PolyQuartic(zeros, jnp.full(C, s0), jnp.full(C, sd0),
                          jnp.full(C, sdd0), Ti, tv, zeros)

        tc = jnp.broadcast_to(ts, (C, n_steps)).T       # (N, C)
        d, d_d, d_dd, d_ddd = (f(tc).T for f in
                               (lat.f, lat.df, lat.ddf, lat.dddf))
        s, s_d, s_dd, s_ddd = (f(tc).T for f in
                               (lon.f, lon.df, lon.ddf, lon.dddf))

        # jerk / time / terminal-deviation costs (poly_sampling.cpp:66-149)
        Jp = jnp.sum(d_ddd ** 2, axis=1)
        Js = jnp.sum(s_ddd ** 2, axis=1)
        Jright = jnp.sum(jnp.where(d < 0.0, -d, 0.0), axis=1)
        cd = (pp["k_j"] * Jp + pp["k_t"] * Ti
              + pp["k_d"] * (pp["trg_d"] - d[:, -1]) ** 2
              + pp["k_overtake_right"] * Jright)
        cv = (pp["k_j"] * Js + pp["k_t"] * Ti
              + pp["k_v"] * (100.0 - s_d[:, -1]) ** 2)
        cost = pp["k_lat"] * cd + pp["k_lon"] * cv

        # cartesian conversion (poly_sampling.cpp:151-190)
        ref_s = path[:, 3]
        heading_frenet = jnp.arctan(d_d / jnp.where(s_d == 0, 1e-9, s_d))
        rx = lerp_xs(s, ref_s, path[:, 0])
        ry = lerp_xs(s, ref_s, path[:, 1])
        rh = lerp_xs(s, ref_s, path[:, 2], angle=True)
        rv = lerp_xs(s, ref_s, path[:, 5])

        x = rx - jnp.sin(rh) * d
        y = ry + jnp.cos(rh) * d
        yaw = heading_frenet + rh

        seg = jnp.hypot(jnp.diff(x, axis=1), jnp.diff(y, axis=1))
        curv_in = short_angle_dist(yaw[:, :-1], yaw[:, 1:]) \
            / jnp.maximum(seg, 1e-9)
        curv = jnp.concatenate([curv_in, curv_in[:, -1:]], axis=1)

        # constraint penalties (poly_sampling.cpp:192-258)
        cost += PENALTY * jnp.sum(
            jnp.maximum(0.0, jnp.abs(s_d) - rv), axis=1)
        cost += PENALTY * jnp.sum(
            jnp.maximum(0.0, jnp.abs(curv) - pp["k_max"]), axis=1)
        cost += PENALTY * jnp.sum(
            jnp.maximum(0.0, jnp.abs(s_dd) - pp["a_max"]), axis=1)
        cost += PENALTY * jnp.sum(jnp.maximum(0.0, jnp.abs(d) - 4.0), axis=1)

        # dense collision screen: ego hull posed at every (cand, step)
        # against every obstacle hull; padded/invalid obstacles masked.
        # The ego is a RECTANGLE, so the generic polygon SAT collapses:
        # separation on the ego's two axes is an interval test on
        # obstacle vertices transformed into the ego frame, and the
        # posed rectangle's projection onto each obstacle edge normal
        # is an analytic support interval — ~10x less work and temp
        # memory than materializing per-pose polygon projections.
        if n_obs > 0:
            x0e = -pp["rear_axis_to_rear"]      # ego rect in its frame:
            x1e = pp["rear_axis_to_front"]      # [x0e, x1e] x [-be, be]
            be = pp["width_ego"] / 2
            cs, sn = jnp.cos(yaw), jnp.sin(yaw)            # (C, N)

            # obstacle vertices in the ego frame: q = R(yaw)^T (v - c)
            rel = (obs_hulls[None, None]                    # (1,1,O,K,2)
                   - jnp.stack([x, y], -1)[:, :, None, None, :])
            qx = (rel[..., 0] * cs[..., None, None]
                  + rel[..., 1] * sn[..., None, None])      # (C, N, O, K)
            qy = (-rel[..., 0] * sn[..., None, None]
                  + rel[..., 1] * cs[..., None, None])
            sep_ego = ((qx.max(-1) < x0e) | (qx.min(-1) > x1e)
                       | (qy.max(-1) < -be) | (qy.min(-1) > be))

            # obstacle edge normals are pose-independent: each obstacle's
            # own projection interval is a constant per axis, and the
            # rectangle's interval on axis n is center·n ± support
            nrm = _edges_normals(obs_hulls)                  # (O, K, 2)
            po = jnp.einsum("oka,oja->okj", obs_hulls, nrm)  # (O, Kv, Ka)
            po_min, po_max = po.min(-2), po.max(-2)          # (O, K)
            # axis n in the ego frame: (n·[cs,sn], n·[-sn,cs])
            nx = (nrm[None, None, ..., 0] * cs[..., None, None]
                  + nrm[None, None, ..., 1] * sn[..., None, None])
            ny = (-nrm[None, None, ..., 0] * sn[..., None, None]
                  + nrm[None, None, ..., 1] * cs[..., None, None])
            pc = (nrm[None, None, ..., 0] * x[..., None, None]
                  + nrm[None, None, ..., 1] * y[..., None, None])
            hi = jnp.maximum(nx * x0e, nx * x1e) + jnp.abs(ny) * be
            lo = jnp.minimum(nx * x0e, nx * x1e) - jnp.abs(ny) * be
            sep_obs = jnp.any((pc + hi < po_min[None, None])
                              | (pc + lo > po_max[None, None]), -1)

            hits = ~(sep_ego | sep_obs) & obs_valid[None, None, :]
            cost += PENALTY * jnp.sum(hits, axis=(1, 2)).astype(f32)

        # ONE packed result array -> one device->host pull per tick
        best = jnp.argmin(cost)
        pick = lambda a: a[best]
        ds = jnp.concatenate([pick(seg), jnp.zeros(1, f32)])
        rows = [pick(a) for a in (d, d_d, d_dd, s, s_d, s_dd,
                                  x, y, yaw, curv)] + [ds]
        packed = jnp.stack(rows)                       # (11, N)
        return packed, cost[best]

    return run


OUT_KEYS = ("d", "d_d", "d_dd", "s", "s_d", "s_dd", "x", "y", "yaw",
            "c", "ds")


def unpack_result(packed, cost):
    out = {k: np.asarray(packed[i]) for i, k in enumerate(OUT_KEYS)}
    out["cost"] = float(cost)
    return out


def pack_obstacles(obstacles, pad_multiple=4):
    """Pad variable obstacle hulls to a fixed (O, K, 2) block.

    Degenerate hulls (<3 vertices) are dropped; vertex padding repeats
    the last vertex (SAT-safe); obstacle-count padding rounds up to
    ``pad_multiple`` so the kernel compiles for a few size buckets only.
    Returns (hulls (O, K, 2) f32, valid (O,) bool).
    """
    hulls = [np.asarray(o["hull"], np.float32)[:, :2] for o in obstacles]
    hulls = [h for h in hulls if len(h) >= 3]
    n = len(hulls)
    O = max(pad_multiple, int(np.ceil(n / pad_multiple)) * pad_multiple) \
        if n else 0
    if O == 0:
        return np.zeros((0, 3, 2), np.float32), np.zeros(0, bool)
    K = max(len(h) for h in hulls)
    out = np.zeros((O, K, 2), np.float32)
    valid = np.zeros(O, bool)
    for i, h in enumerate(hulls):
        out[i, :len(h)] = h
        out[i, len(h):] = h[-1]
        valid[i] = True
    # padded entries: repeat the first hull so SAT math stays finite
    out[n:] = out[0]
    return out, valid
