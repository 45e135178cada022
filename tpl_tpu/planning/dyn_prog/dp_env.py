"""
EnvironmentState -> DpEnvironment adapter.

Feeds the device-resident Frenet grid world model (`DpEnvironment`) from
the shared environment snapshot each planning tick.  The module is a set
of pure builder functions — reference-line packing, conflict-zone
marking, prediction sweep collection — composed by a small stateful
`DpEnv` front end that owns only what genuinely persists across ticks
(the previous reference line for shift bookkeeping, the fractional grid
phase, debug throttling).

Behavior-parity target: library/tpl/planning/dyn_prog/dp_env.py (the
reference's CUDA/GL-backed equivalent).
"""

import time

import numpy as np
import jax

from tpl_tpu import util
from tpl_tpu.util import Bundle, snapshot
from tpl_tpu.ops import rampify_profile
from tpl_tpu.planning.dyn_prog.dp_environment import (
    DpEnvironment, DpEnvParams, gen_prediction_quads,
)

# ref-line packing: columns 0..5 are the local-map path (x, y, phi, s,
# k, v), then corridor half-widths and the semantic channel
RL_D_LEFT, RL_D_RIGHT, RL_SEMANTIC = 6, 7, 8
RL_V = 5
CONFLICT_ZONE_CELLS = 10


class Params:

    def __init__(self):
        self.write_debug_data = True
        # grid debug dumps are full device->host pulls, so they refresh
        # at their own rate instead of every tick (the reference pulls
        # every update: dp_env.py:174-189)
        self.debug_grid_interval = 0.3
        self.dead_time = 0.0

        self.a_lat_max = 2.5

        self.a_max_v_ref = 3.0
        self.a_min_v_ref = -3.0
        self.j_max_v_ref = 1.5
        self.j_min_v_ref = -1.5

        self.t_dist_on_map = 0.5
        self.t_dist_crossing = 3.0

        self.cpp = DpEnvParams()


def smooth_ref_velocity(v, a_min, a_max, j_min, j_max, step_size):
    """Jerk/acc-limited ramp over a ref-line velocity channel so the DP
    velocity constraint has no steps; cells the map pins to (near) zero
    stay hard zero so stop lines survive the smoothing."""
    pinned_zero = v < 1.0
    out = rampify_profile(None, None, v, a_min, a_max, j_min, j_max,
                          1.0, step_size)[:, 0]
    out[pinned_zero] = 0.0
    return out


def pack_ref_line(local_map, params, pad_to_multiple=64):
    """Pack the local map window into the 9-column device ref line.

    The row count is padded up to a multiple of ``pad_to_multiple``:
    XLA recompiles the fused env-build+solve program for every new
    ref-line length, and near the route end (or across junction map
    switches) the sliding window shrinks row by row — measured as a
    recompile per replan costing minutes each on the host backend
    (jungingen_right seed 2 spent 205 s of wall between sim t=8 and
    t=10 before this padding). Bucketing lengths to 64-row (32 m)
    bands bounds recompiles to band crossings. The padding is a
    straight zero-velocity continuation of the last row: it lies
    beyond the grid's ``s_max`` — ``DpEnvironment.device_inputs``
    enforces that the TRUE (unpadded) window covers ``s_max`` via the
    ``true_rows`` count recorded in ``set_ref_line``, so padded rows
    can never substitute for missing map geometry — copies
    d_left/d_right so ``fit_lateral_range`` sees the same extrema, and
    keeps v = 0 so stop-at-route-end semantics hold even if read.
    """
    n = len(local_map.path)
    rl = np.zeros((n, 9))
    rl[:, :6] = local_map.path
    rl[:, RL_D_LEFT] = local_map.d_left
    rl[:, RL_D_RIGHT] = local_map.d_right
    rl[:, RL_V] = smooth_ref_velocity(
        rl[:, RL_V], params.a_min_v_ref, params.a_max_v_ref,
        params.j_min_v_ref, params.j_max_v_ref, local_map.step_size_ref)

    cap = -(-n // pad_to_multiple) * pad_to_multiple
    if cap > n:
        step = local_map.step_size_ref
        h = rl[-1, 2]
        k = np.arange(1, cap - n + 1)
        pad = np.repeat(rl[-1:], cap - n, axis=0)
        pad[:, 0] = rl[-1, 0] + np.cos(h) * step * k
        pad[:, 1] = rl[-1, 1] + np.sin(h) * step * k
        pad[:, 3] = rl[-1, 3] + step * k       # arc length continues
        pad[:, 4] = 0.0                        # straight: no curvature
        pad[:, RL_V] = 0.0
        rl = np.concatenate([rl, pad], axis=0)
    return rl


def mark_conflict_zones(ref_line, intersection_paths, skip_oob=False):
    """Flag the semantic channel over each intersection conflict zone.

    With ``skip_oob=False`` (the lat/lon DP env), returns False when any
    crossing path's stop point fell outside the window — the caller must
    then keep its previous lateral grid range (parity with the
    reference's early-out, dp_env.py:108-112, which skips the
    l_min/l_max refit in that case).  With ``skip_oob=True`` (the
    graph/poly DP driver) out-of-window stop points are simply ignored
    and the in-window zones are still marked.
    """
    for ip in intersection_paths:
        if not ip.stop_proj.in_bounds:
            if skip_oob:
                continue
            return False
        i0 = ip.stop_proj.end
        ref_line[i0:i0 + CONFLICT_ZONE_CELLS, RL_SEMANTIC] = 1.0
    return True


def fit_lateral_range(ref_line, cpp_params):
    """Widen the grid's lateral extent to cover the whole road."""
    cpp_params.l_min = float(np.floor(np.min(-ref_line[:, RL_D_RIGHT])))
    cpp_params.l_max = float(np.ceil(np.max(ref_line[:, RL_D_LEFT])))


def sweep_seconds(on_local_map, ego_v, obj_a, params):
    """How far along its path a predicted object is swept per time
    slice.  Objects on the ego corridor get a tight sweep; crossing
    traffic is swept longer the faster the ego (or the object)
    approaches, over-approximating the conflict window."""
    if on_local_map:
        return params.t_dist_on_map
    if ego_v > 20.0 or (obj_a is not None and obj_a > 1.0):
        return 4.0
    if ego_v > 15.0:
        return 3.0
    if ego_v > 10.0:
        return 2.0
    return params.t_dist_crossing


def collect_prediction_sweeps(env, params):
    """Yield (quads, stationary) swept-footprint batches for every
    prediction that is associated with a relevant map.

    Prediction timestamps are phase-shifted by the grid's fractional
    ``dt_start`` and the actuation dead time before sweeping, then the
    dead time is subtracted again from the emitted slice times so the
    grid stays indexed in plan time.
    """
    maps = {m.uuid: m for m in env.get_relevant_maps()}
    ego_v = env.vehicle_state.v

    for obj in env.predicted:
        for pred in obj.predictions:
            m = maps.get(pred.uuid_assoc_map)
            if m is None:
                continue

            ts = np.concatenate(
                ([0.0], params.cpp.dt_start + pred.states[:-1, 0]))
            ts += params.dead_time

            window = sweep_seconds(m.name == "local_map_behind",
                                   ego_v, obj.a, params)
            quads = gen_prediction_quads(
                pred.states, obj.hull, m.path[:, :2], ts,
                station_step_size=5.0, expansion_rate=0.0,
                sweep_length=window)
            yield ([(q, t - params.dead_time) for q, t in quads],
                   obj.stationary)


class DpEnv:
    """Tick-to-tick front end over the device grid builder.

    Persistent state is deliberately minimal:
      * the previous ref line + step size — to measure how far the map
        window slid (`ref_line_shift`), which planners use to de-shift
        warm-started trajectories;
      * the fractional time-slice phase `dt_start` — keeps grid slices
        aligned to wall time across replans whose period is not a
        multiple of the grid dt;
      * debug-pull throttling.
    """

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared
        with self.lock_shared():
            if not hasattr(self.shared, "params"):
                self.shared.params = Bundle()
            self.shared.params.env = Params()
            if not hasattr(self.shared, "debug"):
                self.shared.debug = Bundle()
            self.shared.debug.env = Bundle()

        self.cpp_env = DpEnvironment()

        self.ref_line = None
        self.ref_line_shift = 0.0
        self.ref_line_step_size = 0.0
        self.ref_line_true_rows = 0

        self.dt_start = None
        self.last_update_time = 0.0
        self.runtime_environment = 0.0
        self._last_debug_grid_t = -np.inf
        self._deferred = None

    # -- params ---------------------------------------------------------

    def _advance_phase(self, env, params):
        """Slide the fractional grid phase by the elapsed wall time."""
        if self.dt_start is None:
            self.dt_start = params.cpp.dt
        else:
            elapsed = env.t - self.last_update_time
            self.dt_start = (self.dt_start - elapsed) % params.cpp.dt
        params.cpp.dt_start = self.dt_start

    def snapshot_params(self, env):
        with self.lock_shared():
            params = self.shared.params.env
            params.cpp.dilation = (np.sqrt(2.0)
                                   * env.vehicle_state.width * 0.5)
            self._advance_phase(env, params)
            return snapshot(params)

    # -- per-tick build ---------------------------------------------------

    def refresh_ref_line(self, env, params):
        new_start = env.local_map.path[0, :2]
        if self.ref_line is not None:
            # quantized arc-length slide of the window since last tick
            arc = util.project(self.ref_line[:, :2], new_start).arc_len
            self.ref_line_shift = (round(arc / self.ref_line_step_size)
                                   * self.ref_line_step_size)

        self.ref_line = pack_ref_line(env.local_map, params)
        self.ref_line_true_rows = len(env.local_map.path)
        self.ref_line_step_size = env.local_map.step_size_ref

        if mark_conflict_zones(self.ref_line,
                               env.local_map.intersection_paths):
            fit_lateral_range(self.ref_line, params.cpp)

    def build_grids(self, env, params, defer_device=False):
        start = time.perf_counter()
        self.cpp_env.reinit_buffers(params.cpp)
        self.cpp_env.set_ref_line(self.ref_line, self.ref_line_step_size,
                                  true_rows=self.ref_line_true_rows)
        for quads, stationary in collect_prediction_sweeps(env, params):
            self.cpp_env.insert_geometry(quads, stationary)
        if not defer_device:
            self.cpp_env.update()
        self.runtime_environment = (time.perf_counter() - start) * 1000.0

    def update(self, env, defer_device=False):
        params = self.snapshot_params(env)
        self.refresh_ref_line(env, params)
        self.build_grids(env, params, defer_device=defer_device)
        if defer_device:
            # the caller runs the device build inside its fused program
            # and then calls finish_deferred_update
            self._deferred = (env, params)
        else:
            self._finalize(env, params)

    def finish_deferred_update(self):
        env, params = self._deferred
        self._deferred = None
        self._finalize(env, params)

    def _finalize(self, env, params):
        if params.write_debug_data:
            self.write_debug_data(env, params)
        self.last_update_time = env.t

    # -- observability ----------------------------------------------------

    def write_debug_data(self, env, params):
        due = (env.t - self._last_debug_grid_t >= params.debug_grid_interval
               or env.t < self._last_debug_grid_t)
        grids = None
        if due:
            grid = self.cpp_env.grid
            # one batched pull for both maps (single round trip)
            grids = jax.device_get((grid.occ_map, grid.dist_map_lon))
            self._last_debug_grid_t = env.t
        cpp = self.cpp_env
        with self.lock_shared():
            dbg = self.shared.debug.env
            dbg.runtime_environment = self.runtime_environment
            dbg.ref_line = self.ref_line
            if grids is not None:
                dbg.occ_map = np.asarray(grids[0])
                dbg.dist_map_lon = np.asarray(grids[1])
            # grid geometry for observers (gui/renderers.py): world-frame
            # (x, y, phi) anchors at ref-line spacing, plus the occ
            # grid's own (s, l) cell coordinates — the two spacings
            # differ (anchor rows at step_size_ref, occ cells at
            # (s_max-s_min)/(s_steps-1))
            if cpp.ref_line is not None:
                anchor = cpp.ref_line[:, :3].copy()
                anchor[:, 0] += cpp.x_offset
                anchor[:, 1] += cpp.y_offset
                dbg.grid_anchor = anchor
                dbg.grid_s_step = cpp.ref_step
                dbg.grid_s_min = params.cpp.s_min
                dbg.grid_s_cell = (params.cpp.s_max - params.cpp.s_min) \
                    / max(params.cpp.s_steps - 1, 1)
                dbg.grid_l_min = params.cpp.l_min
                dbg.grid_l_step = (params.cpp.l_max - params.cpp.l_min) \
                    / max(params.cpp.l_steps - 1, 1)
